"""Condition expression language: AST and parser (the compile path only)."""

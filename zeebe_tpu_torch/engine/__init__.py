"""Engine-side host helpers (key strides)."""

"""Record enums and intents (copies of ``zeebe_tpu.protocol`` modules)."""

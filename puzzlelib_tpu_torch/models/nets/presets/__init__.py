"""Turn-key training presets."""

"""Architecture configs (dense decoders)."""

"""Model stack: the dense decoder (other families come later)."""

"""Models of the port (``vit.AudioViT``: the static-pruned eval path)."""

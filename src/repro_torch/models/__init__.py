"""The LM substrate: layers and the dense-attention model (see model.py)."""

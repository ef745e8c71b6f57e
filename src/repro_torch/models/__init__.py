"""The LM substrate: layers, the Mamba, MoE and xLSTM blocks, and the
model that assembles them (see model.py)."""

"""Parameter spaces and the estimation loop (Vamana slice)."""

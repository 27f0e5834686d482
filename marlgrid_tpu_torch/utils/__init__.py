"""Host-side utilities of the PyTorch port: the JSONL metrics stream and
the torch-native checkpoint."""

"""Host-side utilities of the PyTorch port: the JSONL metrics stream and
rate counter, the torch-native checkpoint and episode video export."""

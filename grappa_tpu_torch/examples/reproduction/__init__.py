"""Examples: see grappa_tpu_torch.examples."""

"""Model accounting (PyTorch port of the accounting half of
``repro.roofline``): parameter counts and model FLOPs."""

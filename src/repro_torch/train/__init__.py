"""Training: AdamW and the train step and driver."""

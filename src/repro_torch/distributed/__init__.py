"""The distributed layer: a device mesh over ``torch.distributed``."""

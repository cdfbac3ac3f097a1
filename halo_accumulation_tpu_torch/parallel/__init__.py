"""Multi-device paths of the port, on torch.distributed."""

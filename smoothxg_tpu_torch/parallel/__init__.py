"""Multi-process (torch.distributed) and multi-card block sharding."""

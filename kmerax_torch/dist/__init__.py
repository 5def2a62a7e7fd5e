"""The ("data", "bucket") mesh over torch.distributed (port of
kmerax/dist)."""

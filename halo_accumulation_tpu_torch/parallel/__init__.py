"""Multi-device paths of the port, on torch.distributed: the sharded MSM
and the collectives of the mesh paths (msm_sharded), and the dry run
(dryrun)."""

"""Multi-rank sharding of the witness pipeline on torch.distributed: the
mesh and its collectives (comm), starting a world of ranks (launch), the
sharded MSM and witness trees (mesh) and the all_to_all-sharded NTT pair
and merge tail (dist_ntt)."""

from . import comm, dist_ntt, launch, mesh

"""Sharded execution over ``torch.distributed``: the mesh and the explicit
exchanges of sharded MF training."""

from sfd2_torch.parallel.mesh import Mesh, make_mesh, put_batch, put_replicated, replicate, shard_batch

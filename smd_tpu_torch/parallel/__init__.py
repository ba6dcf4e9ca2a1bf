from smd_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshConfig, initialize_distributed, make_mesh, param_spec,
    shard_batch, shard_params,
)

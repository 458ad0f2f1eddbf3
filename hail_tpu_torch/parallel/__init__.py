from .mesh import get_mesh, reset_mesh, n_devices, shard_2d, shard_rows, replicate

__all__ = ['get_mesh', 'reset_mesh', 'n_devices', 'shard_2d', 'shard_rows', 'replicate']

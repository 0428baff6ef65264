from real_esrgan_tpu_torch.parallel.mesh import (
    all_reduce_mean, broadcast_pytree, broadcast_string, is_lead, local_device, local_devices,
    maybe_initialize_distributed, process_group, rank, shard_slice, world_size,
)

from slam_tpu_torch.models import fake_lidar, mcl, slam  # noqa: F401

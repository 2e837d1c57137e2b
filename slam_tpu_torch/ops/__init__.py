from slam_tpu_torch.ops import (  # noqa: F401
    edt,
    lut,
    mapping,
    measurement,
    motion,
    raycast,
    rayfield,
    resample,
)

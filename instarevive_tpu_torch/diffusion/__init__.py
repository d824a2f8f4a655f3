from instarevive_tpu_torch.diffusion.schedules import (  # noqa: F401
    DiffusionSchedule,
    make_schedule,
    named_betas,
)
from instarevive_tpu_torch.diffusion.one_step import (  # noqa: F401
    eps_to_x0,
    generate_sample_1step,
)
from instarevive_tpu_torch.diffusion import gaussian, respace  # noqa: F401

"""The port's ray, interpolation, compositing and shading primitives, under
the names ``tensoir_tpu.ops`` exports."""
from tensoir_tpu_torch.ops.interp import (  # noqa: F401
    bilerp_plane,
    lerp_line,
    trilerp_volume,
    bilerp_image_nchw_like,
    resize_bilinear_align_corners,
)
from tensoir_tpu_torch.ops.compositing import (  # noqa: F401
    raw2alpha,
    raw2alpha_from_sigma,
)
from tensoir_tpu_torch.ops.rays import (  # noqa: F401
    aabb_ray_tmin,
    aabb_intersect,
    sample_ray,
    sample_ray_equally,
    sample_pdf,
)
from tensoir_tpu_torch.ops.color import linear2srgb, srgb2linear  # noqa: F401
from tensoir_tpu_torch.ops.pe import positional_encoding  # noqa: F401
from tensoir_tpu_torch.ops.brdf import ggx_specular  # noqa: F401
from tensoir_tpu_torch.ops.sh import eval_sh_bases  # noqa: F401

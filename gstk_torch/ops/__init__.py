from gstk_torch.ops.projection import ProjectedGaussians, project_gaussians
from gstk_torch.ops.sh import num_sh_bases, spherical_harmonics
from gstk_torch.ops.binning import Intersections, bin_gaussians
from gstk_torch.ops.rasterize import rasterize, RasterizeConfig

__all__ = [
    "ProjectedGaussians",
    "project_gaussians",
    "num_sh_bases",
    "spherical_harmonics",
    "Intersections",
    "bin_gaussians",
    "rasterize",
    "RasterizeConfig",
]

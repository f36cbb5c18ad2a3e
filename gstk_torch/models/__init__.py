from gstk_torch.models.vanilla import VanillaConfig, render_scene

__all__ = ["VanillaConfig", "render_scene"]

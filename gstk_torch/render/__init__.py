from gstk_torch.render.renderer import Renderer

__all__ = ["Renderer"]

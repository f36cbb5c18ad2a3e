from gstk_torch.exporter.gaussian_ply import export_gaussian_ply, load_gaussian_ply

__all__ = ["export_gaussian_ply", "load_gaussian_ply"]

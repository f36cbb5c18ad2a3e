from gstk_torch.configs.methods import method_configs

__all__ = ["method_configs"]

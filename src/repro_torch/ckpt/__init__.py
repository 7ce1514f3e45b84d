from repro_torch.ckpt.checkpoint import latest_step, restore, save, save_async

__all__ = ["latest_step", "restore", "save", "save_async"]

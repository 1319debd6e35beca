"""Multi-device steps on torch.distributed (`multi`) and the launcher that
starts their ranks (`launch`)."""

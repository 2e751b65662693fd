"""Plain PyTorch oracle for the SSD kernel: the naive per-token recurrence,
as ``repro.kernels.ssd_scan.ref`` takes it from the model module."""

from repro_torch.models.ssm import ssd_reference as ref_ssd  # one source

__all__ = ["ref_ssd"]

"""Hand-written CUDA kernels (``csrc/``) with their bindings, plain
PyTorch versions and public wrappers, one package per reference kernel."""


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter (``.launches``), by the name
    ``chip_smoke.py``'s kernels line and ``launch/dryrun.py``'s records
    use."""
    from .attention.kernel import FLASH_ATTENTION, FLASH_ATTENTION_BWD
    from .features.kernel import BRANCH_HISTORY, MEMDIST_DELTA
    from .fused.kernel import FUSED_FEATURES
    from .ssd.kernel import SSD_SCAN, SSD_SCAN_BWD

    return {"fused_features": FUSED_FEATURES, "flash_attention": FLASH_ATTENTION,
            "branch_history": BRANCH_HISTORY, "memdist_delta": MEMDIST_DELTA, "ssd": SSD_SCAN,
            "flash_attention_bwd": FLASH_ATTENTION_BWD, "ssd_bwd": SSD_SCAN_BWD}

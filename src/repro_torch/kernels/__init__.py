"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each beside
its plain PyTorch version."""


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from .approx_topk import kernel, persistent
    from .embedding_bag import kernel as bag
    from .flash_attention import kernel as flash

    kernel.launches = 0
    persistent.launches = 0
    flash.launches = 0
    bag.launches = 0


def launch_counts() -> dict:
    from .approx_topk import kernel, persistent
    from .embedding_bag import kernel as bag
    from .flash_attention import kernel as flash

    return {"approx_topk": kernel.launches,
            "persistent_round": persistent.launches,
            "flash_attention": flash.launches,
            "embedding_bag": bag.launches}

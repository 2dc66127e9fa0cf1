"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each beside
its plain PyTorch version."""

import threading


class LaunchCounter:
    """A kernel wrapper's launch count, safe to add to from any thread: the
    replicas of a router launch from their own threads, and a bare
    ``count += 1`` (a read, an add, a write) can lose an update between
    them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad: the
    kernel ``name`` has no backward (nor has its TPU kernel), so its output
    would silently carry no ``grad_fn``.  The plain versions, on the CPU,
    stay differentiable."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"the {name} kernel has no backward: call it under "
                           "torch.no_grad() or on tensors that do not require grad")


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for counter in _counters().values():
        counter.reset()


def launch_counts() -> dict:
    return {name: counter.value for name, counter in _counters().items()}


def _counters() -> dict:
    from .approx_topk import kernel, persistent
    from .embedding_bag import kernel as bag
    from .flash_attention import kernel as flash
    from .tensor_product import kernel as tp

    return {"approx_topk": kernel.launches,
            "persistent_round": persistent.launches,
            "flash_attention": flash.launches,
            "embedding_bag": bag.launches,
            "embedding_bag_backward": bag.backward_launches,
            "tensor_product": tp.launches,
            "tensor_product_backward": tp.backward_launches}

"""GPU accelerator manager: detection, visibility, multi-host slices.

The counterpart of `ray_tpu/_private/accelerators/tpu.py`, for hosts of
NVIDIA cards:
- card detection through the runtime's own probe (`detect_num_gpus`:
  `nvidia-smi -L` and `CUDA_VISIBLE_DEVICES`, no CUDA context made);
- card-subset visibility through `CUDA_VISIBLE_DEVICES`, and the card
  pool a node's scheduler leases cards from (`CardPool`): every lease
  that holds `GPU` holds named cards, and the worker that runs it sets
  `CUDA_VISIBLE_DEVICES` to them (`set_visible_accelerators`) before the
  task or the actor's constructor runs, so the cards a worker reserves
  are the cards it drives, and no other worker's;
- slice resources: a slice of hosts (a GPU "pod") schedules as one unit
  when every host of it advertises `{<pod_name>: 1}` and host 0 also
  `{GPU-<generation>-head: 1}`, so "one actor per host, addressed as a
  unit" is a plain resource request.

An accelerator type reads "<generation>-<cards>": "h100-8" is one 8-card
HGX host, "h100-16" two of them, "h100-1" one host with one card. The
type, the slice's name and the host's index in it come from
`RAY_TPU_ACCELERATOR_TYPE`, `RAY_TPU_POD_NAME` and
`RAY_TPU_POD_WORKER_ID` (a GPU host has no TPU-VM runtime to set them).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# cards per host by generation: the SXM parts ship in 8-card HGX boards
_CARDS_PER_HOST = {"a100": 8, "h100": 8, "h200": 8, "b200": 8}


def parse_accelerator_type(accelerator_type: str) -> tuple:
    """'h100-16' -> ('h100', 16). Raises on malformed input."""
    parts = accelerator_type.lower().split("-")
    if len(parts) != 2 or not parts[1].isdigit() or int(parts[1]) < 1:
        raise ValueError(
            f"malformed GPU accelerator type {accelerator_type!r}; "
            f"expected e.g. 'h100-8', 'h100-16'")
    gen, size = parts[0], int(parts[1])
    if gen not in _CARDS_PER_HOST:
        raise ValueError(f"unknown GPU generation {gen!r} "
                         f"(known: {sorted(_CARDS_PER_HOST)})")
    return gen, size


def cards_per_host(accelerator_type: str) -> int:
    gen, size = parse_accelerator_type(accelerator_type)
    return min(_CARDS_PER_HOST[gen], size)


def num_hosts(accelerator_type: str) -> int:
    """Hosts in the slice (>=1)."""
    gen, size = parse_accelerator_type(accelerator_type)
    return max(1, -(-size // _CARDS_PER_HOST[gen]))


def head_resource_name(accelerator_type: str) -> str:
    gen, _ = parse_accelerator_type(accelerator_type)
    return f"GPU-{gen}-head"


def detect_num_gpus() -> int:
    # the runtime imports the scheduler, which imports this module
    from ray_tpu_torch._private.runtime import detect_num_gpus as probe
    return probe()


# ------------------------------------------------ cards pinned to leases
_EPS = 1e-9

# A lease's cards: ((card index, share of that card), ...) by index.
Cards = Tuple[Tuple[int, float], ...]


def card_names(n: int) -> List[str]:
    """What `CUDA_VISIBLE_DEVICES` calls cards 0..n-1 of this node: the
    entries of this process's own `CUDA_VISIBLE_DEVICES` where it names
    that many, else the ordinals."""
    var = os.environ.get("CUDA_VISIBLE_DEVICES") or ""
    entries = [e.strip() for e in var.split(",") if e.strip()]
    if len(entries) >= n:
        return entries[:n]
    return [str(i) for i in range(n)]


class CardPool:
    """The free share of each card of a node, or of a placement-group
    bundle carved out of it (1.0 = the whole card is free).

    `choose` picks a lease's cards without charging them: a whole count
    takes whole free cards (lowest index first); a fraction packs onto
    the card with the least share left that still holds it, so two
    `num_gpus=0.5` leases share one card. `charge` and `refund` move
    shares; a charge may drive a share below 0 where the scheduler
    oversubscribes on purpose (a blocked worker resuming)."""

    def __init__(self, free: Optional[Dict[int, float]] = None):
        self.free: Dict[int, float] = dict(free or {})

    @classmethod
    def of_node(cls, gpus: float) -> "CardPool":
        whole = int(gpus + _EPS)
        free = {i: 1.0 for i in range(whole)}
        if gpus - whole > _EPS:
            free[whole] = gpus - whole
        return cls(free)

    def choose(self, amount: float,
               only: Optional[Sequence[int]] = None) -> Optional[Cards]:
        """Cards for a lease of `amount` GPUs, or None when this pool
        cannot hold it. `only` limits the choice to exactly those cards
        (a worker bound to them)."""
        whole = int(amount + _EPS)
        frac = amount - whole if amount - whole > _EPS else 0.0
        ids = sorted(self.free) if only is None else sorted(only)
        full = [i for i in ids if self.free.get(i, 0.0) >= 1.0 - _EPS]
        if len(full) < whole:
            return None
        out = [(i, 1.0) for i in full[:whole]]
        if frac:
            taken = set(full[:whole])
            fits = [i for i in ids if i not in taken
                    and self.free.get(i, 0.0) >= frac - _EPS]
            if not fits:
                return None
            out.append((min(fits, key=lambda i: (self.free[i], i)), frac))
        if only is not None and len(out) != len(ids):
            return None
        return tuple(sorted(out))

    def charge(self, cards: Optional[Cards]) -> None:
        for i, share in cards or ():
            self.free[i] = self.free.get(i, 0.0) - share

    def refund(self, cards: Optional[Cards]) -> None:
        for i, share in cards or ():
            self.free[i] = self.free.get(i, 0.0) + share


def sub_cards(cards: Optional[Cards], amount: float) -> Optional[Cards]:
    """The cards of a lease of `amount` GPUs that rides inside the lease
    `cards` (a task pipelined behind another on its worker), on the same
    cards; None when it cannot be."""
    if not cards:
        return None
    return CardPool(dict(cards)).choose(amount,
                                        only=[i for i, _ in cards])


# ------------------------------------------------- the worker's side
_marked_bound = False


def mark_cuda_bound() -> None:
    """Declare that this process has fixed its card set: it initialised
    CUDA by a route `cuda_bound` cannot see (a C extension calling
    cuInit). Its worker then takes only leases of the cards it sees."""
    global _marked_bound
    _marked_bound = True


def cuda_bound() -> bool:
    """Whether this process's visible card set is fixed: once the CUDA
    driver is initialised (cuInit: a context, or one `cudaGetDeviceCount`
    as `torch.cuda.is_available()` makes), or torch has cached a device
    count, a new `CUDA_VISIBLE_DEVICES` changes nothing. Loading the
    driver library alone (`import torch` does) fixes nothing."""
    if _marked_bound:
        return True
    torch = sys.modules.get("torch")
    if torch is not None:
        cuda = torch.cuda
        try:
            if cuda._is_compiled() and (
                    cuda.is_initialized()
                    or getattr(cuda, "_cached_device_count", None)
                    is not None):
                return True
        except Exception:
            return True
    return _driver_initialized()


def _driver_initialized() -> bool:
    """Whether cuInit has run in this process: the driver library is
    loaded (dlopen with RTLD_NOLOAD finds it by its soname and loads
    nothing) and `cuDeviceGetCount` does not answer
    CUDA_ERROR_NOT_INITIALIZED (3), which every driver call answers
    before cuInit."""
    import ctypes
    try:
        lib = ctypes.CDLL("libcuda.so.1", mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
    except OSError:
        return False
    get_count = lib.cuDeviceGetCount
    get_count.argtypes = [ctypes.POINTER(ctypes.c_int)]
    get_count.restype = ctypes.c_int
    count = ctypes.c_int(0)
    return get_count(ctypes.byref(count)) != 3


class GPUAcceleratorManager:
    """AcceleratorManager-shape API (reference accelerator.py ABC)."""

    RESOURCE_NAME = "GPU"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        return detect_num_gpus()

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return os.environ.get("RAY_TPU_ACCELERATOR_TYPE")

    @staticmethod
    def get_current_pod_name() -> Optional[str]:
        return os.environ.get("RAY_TPU_POD_NAME")

    @staticmethod
    def get_current_pod_worker_id() -> int:
        return int(os.environ.get("RAY_TPU_POD_WORKER_ID", "0"))

    @staticmethod
    def set_visible_accelerators(card_ids: Sequence) -> None:
        """Restrict this process to a subset of the host's cards (ordinals
        or UUIDs), before it initialises CUDA: the one way a worker is
        pinned. After cuInit the set is fixed, so this raises where
        `cuda_bound()` sees another set."""
        var = ",".join(map(str, card_ids))
        if cuda_bound() and os.environ.get("CUDA_VISIBLE_DEVICES") != var:
            raise RuntimeError(
                f"this process has initialised CUDA on "
                f"CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}; it cannot "
                f"be pinned to cards {var!r}")
        os.environ["CUDA_VISIBLE_DEVICES"] = var

    @classmethod
    def get_current_node_additional_resources(cls) -> Dict[str, float]:
        """Slice resources this node should advertise: {pod_name: 1} on
        every host of the slice, plus {GPU-<gen>-head: 1} on host 0."""
        pod = cls.get_current_pod_name()
        if not pod:
            return {}
        out: Dict[str, float] = {pod: 1.0}
        accel = cls.get_current_node_accelerator_type()
        if accel and cls.get_current_pod_worker_id() == 0:
            out[head_resource_name(accel)] = 1.0
        return out

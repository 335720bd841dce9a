"""Mixture-of-Experts FFN: top-k routing + capacity-based dispatch.

Port of `ray_tpu/models/moe.py`. Expert weights carry the "experts"
logical axis (-> the ep mesh axis); dispatch and combine are dense
one-hot einsums, and under a mesh the `constrain` hook redistributes the
expert inputs from token-split to expert-split, which is the token
all-to-all. GShard-style capacity: each expert takes at most
`ceil(tokens·top_k/num_experts · capacity_factor)` tokens, assignments
queued k-major (every token's first choice before any second choice), so
the tokens that drop are the JAX package's; they ride the residual.

Parity property used by tests: with every expert holding the same
weights, normalised top-k routing makes the MoE block exactly equal to
its dense FFN (Σ w_k · F(x) = F(x)) while nothing drops.

`moe_ffn`'s four phases are spans (`_private/tracing_plane.py`):
`moe.route`, `moe.dispatch`, `moe.experts`, `moe.combine`. They are
profiler ranges only while grad mode is on (a training forward, and
remat's recompute in the backward), so no range opens inside a serving
step, which runs under `inference_mode`. Every call also adds its kept
and assigned top-k slots to a tally on the device, without a host sync:
`drop_tally(device)` reads it, `reset_drop_tally()` clears it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch.parallel import collectives

# device -> int64 (kept, assigned) top-k slots, summed over every call
_tallies: Dict[torch.device, torch.Tensor] = {}


def _add_to_tally(kept: torch.Tensor, assigned: int) -> None:
    t = _tallies.get(kept.device)
    if t is None:
        # a normal tensor even under inference_mode, so that calls under
        # and outside it can both add to it
        with torch.inference_mode(False):
            t = _tallies.setdefault(kept.device, torch.zeros(
                2, dtype=torch.int64, device=kept.device))
    t[0] += kept
    t[1] += assigned


def drop_tally(device) -> Dict[str, int]:
    """The top-k slots `moe_ffn` dropped at capacity and those it
    assigned on `device`, summed over every call since the last reset
    (remat's recompute counts a forward again, both counts alike). One
    host sync."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _tallies.get(device)
    kept, assigned = (0, 0) if t is None else t.tolist()
    return {"dropped": assigned - kept, "assigned": assigned}


def reset_drop_tally() -> None:
    _tallies.clear()


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0    # train-time router noise (0 = off)


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    return max(1, int(math.ceil(
        num_tokens * top_k / num_experts * capacity_factor)))


def route(logits: torch.Tensor, top_k: int, capacity: int):
    """Routing of f32 router logits (T, E): (probs (T, E), top_p (T, k)
    renormalised, assign (T, k, E) one-hot int, keep (T, k) bool, dispatch
    (T, E, C) int one-hot over the kept slots). Assignments are queued
    k-major: k = 0 choices win capacity ties."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)           # (T, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)            # renorm

    # Position of each (token, k) assignment within its expert's queue:
    # flatten assignments k-major so k=0 choices win capacity ties.
    assign = F.one_hot(top_e, E).to(torch.int32)               # (T, k, E)
    flat = assign.transpose(0, 1).reshape(top_k * T, E)        # (kT, E)
    pos_flat = torch.cumsum(flat, dim=0) - flat                # (kT, E)
    pos = pos_flat.reshape(top_k, T, E).transpose(0, 1)        # (T, k, E)
    within = (pos * assign).sum(-1)                            # (T, k)
    keep = within < capacity                                   # capacity

    # dispatch (T, k, E, C) one-hot, kept slots only
    disp = (assign[..., None]
            * F.one_hot(within.clamp_max(capacity - 1),
                        capacity).to(torch.int32)[:, :, None, :]
            * keep[:, :, None, None].to(torch.int32))          # (T,k,E,C)
    return probs, top_p, assign, keep, disp


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, gate_w: torch.Tensor,
            up_w: torch.Tensor, down_w: torch.Tensor, *, top_k: int,
            capacity_factor: float,
            constrain: Optional[Callable] = None,
            generator: Optional[torch.Generator] = None,
            router_jitter: float = 0.0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply the MoE FFN block.

    x: (b, s, d). router_w: (d, E). gate/up_w: (E, d, f); down_w:
    (E, f, d). `constrain(tensor, logical_axes)` applies sharding
    constraints (models pass their mesh-bound constrainer). Returns
    (output (b, s, d), aux metrics incl. load-balance loss).
    `generator` with `router_jitter` adds train-time router noise.
    """
    b, s, d = x.shape
    E = router_w.shape[-1]
    T = b * s
    C = expert_capacity(T, E, top_k, capacity_factor)
    cdtype = x.dtype
    ranges = torch.is_grad_enabled()

    with _tp.span("moe", "moe.route", profile=ranges):
        xf = x.reshape(T, d)
        logits = (xf @ router_w.to(cdtype)).to(torch.float32)  # (T, E)
        if router_jitter and generator is not None:
            logits = logits + router_jitter * torch.randn(
                logits.shape, generator=generator, device=logits.device)
        probs, top_p, assign, keep, disp = route(logits, top_k, C)
        combine = (disp.to(torch.float32)
                   * top_p[:, :, None, None]).sum(1)          # (T, E, C)
        dispatch = disp.sum(1).to(cdtype)                     # (T, E, C)

    # expert inputs: tokens (row-split) -> expert-major (ep-split); the
    # constraint's redistribute is the all-to-all.
    with _tp.span("moe", "moe.dispatch", profile=ranges):
        ein = torch.einsum("tec,td->ecd", dispatch, xf)       # (E, C, d)
        if constrain is not None:
            ein = constrain(ein, ("experts", "expert_capacity", "embed"))
    with _tp.span("moe", "moe.experts", profile=ranges):
        h = F.silu(torch.einsum("ecd,edf->ecf", ein, gate_w.to(cdtype)))
        h = h * torch.einsum("ecd,edf->ecf", ein, up_w.to(cdtype))
        if constrain is not None:
            h = constrain(h, ("experts", "expert_capacity", "mlp"))
        eout = torch.einsum("ecf,efd->ecd", h, down_w.to(cdtype))
        if constrain is not None:
            eout = constrain(eout, ("experts", "expert_capacity", "embed"))

    with _tp.span("moe", "moe.combine", profile=ranges):
        y = torch.einsum("tec,ecd->td", combine.to(cdtype), eout)
        y = y.reshape(b, s, d)

    # Aux: switch-style load-balance loss + routing stats. Each kept
    # (token, choice) slot is one 1 of `dispatch` (a token's top-k
    # experts are distinct), so the kept share is keep's.
    frac_tokens = assign[:, 0, :].to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    lb_loss = E * (frac_tokens * frac_probs).sum()
    kept = keep.sum()
    _add_to_tally(kept, T * top_k)
    dropped = 1.0 - kept / (T * top_k)
    return y, {"moe_load_balance_loss": lb_loss,
               "moe_dropped_fraction": dropped}


class ExpertShards:
    """`moe_ffn`'s `constrain` hook on each rank inside `local_map`, where
    the tokens are whole on every rank and each rank holds its experts
    (split over ep) and its slice of the mlp dim (split over tp). The
    three constraints `moe_ffn` makes, in its order, become:

    - ein ("experts", ..., "embed"): the rank's experts, a slice of the
      whole (token-split -> expert-split, the all-to-all of a mesh whose
      tokens were split; its backward gathers every expert's cotangent),
      entering the per-tp-slice matmuls (backward: the tp partial sums
      summed);
    - h ("experts", ..., "mlp"): as it is;
    - eout ("experts", ..., "embed"): the tp partial sums summed, then
      every expert's output gathered, so the combine runs whole on every
      rank and gives the same y everywhere.
    """

    def __init__(self, mesh):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.mesh, self.calls = mesh, 0
        self.ep = sizes.get("ep", 1) > 1
        self.tp = sizes.get("tp", 1) > 1

    def __call__(self, a: torch.Tensor, axes) -> torch.Tensor:
        self.calls += 1
        m = self.mesh
        if self.calls == 1:                      # ein
            if self.ep:
                a = collectives.scatter_to(a, "ep", dim=0, mesh=m)
            return collectives.copy_to(a, "tp", mesh=m) if self.tp else a
        if self.calls == 3:                      # eout
            if self.tp:
                a = collectives.allreduce(a, "tp", mesh=m)
            return collectives.allgather(a, "ep", mesh=m) if self.ep else a
        return a


MOE_PARAM_AXES = {
    "router": ("embed", None),
    "moe_gate": ("experts", "embed", "mlp"),
    "moe_up": ("experts", "embed", "mlp"),
    "moe_down": ("experts", "mlp", "embed"),
}

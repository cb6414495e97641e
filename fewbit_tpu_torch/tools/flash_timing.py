"""Device time of the tensor-core flash kernels F1, F2 and F3 at given shapes.

    python3 -m fewbit_tpu_torch.tools.flash_timing [--case B H S D MODE ...]
        [--wide] [--library] [--dtypes f32 bf16] [--reps 10] [--tries 3]

Each case is (batch, heads, sequence, head dimension, mode): ``causal``
(segment ids all one, as GPT passes them) or ``padded`` (the non-causal
padding mask of RoBERTa's batches, half to all of each row).  Operands are
transposed views of (b, s, h, d) tensors from a seeded generator, as the
models pass them.  For each case and type it prints one JSON line: the
device milliseconds per call of F1, F2 and F3 (the profiler's, or CUDA
events where every profiled run read below the call's bound; see
``act_timing.device_time``), each call's bound and its share of it.  Without
``--case`` it times GPT-2 small's (8, 12, 1024, 64) causal and RoBERTa's
(64, 12, 128, 64) padded; ``--wide`` times the wide kernels' cases
(``WIDE_CASES``: Pythia-1B's (2, 8, 2048, 256) causal, 256 padded, 384
causal, 512 padded, 384 padded at seq 1000), after any ``--case``.
``--library`` adds the device ms of PyTorch's
``scaled_dot_product_attention`` forward and backward on the same inputs
(a yardstick; the port never calls it), floored by F1's and by the larger
of F2's and F3's bounds, the backend its dispatch takes, and each
backend's device ms under ``sdpa_kernel`` (or its refusal).  It calls the
wrappers only, so copied into an older tree it times that tree's kernels
at the head dimensions they take.
``chip_smoke.py`` bounds and times F1-F3 through :func:`flash_work` and
``act_timing.device_time`` too, with the same ``REPS``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json

import torch

__all__ = ("WIDE_CASES", "unmasked", "flash_work", "sdpa_calls",
           "sdpa_backend", "sdpa_backend_times", "time_case", "library_time",
           "main")

DEFAULT_CASES = ((8, 12, 1024, 64, "causal"), (64, 12, 128, 64, "padded"))
# The wide kernels (head dimensions d = 128 c above 128), as chip_smoke.py's
# HEADDIM_FLASH holds them.
WIDE_CASES = ((2, 8, 2048, 256, "causal"), (16, 4, 512, 256, "padded"),
              (4, 4, 1024, 384, "causal"), (2, 4, 1024, 512, "padded"),
              (2, 4, 1000, 384, "padded"))
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Profiled calls per run, as chip_smoke.py times every kernel.
REPS = 10


def _inputs(b, h, s, d, mode, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2) for _ in range(4))
    if mode == "causal":
        ids = torch.ones(b, s, dtype=torch.int32, device="cuda")
    else:
        lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                device="cuda")
        ids = (torch.arange(s, device="cuda")[None]
               < lengths[:, None]).int()
    return q, k, v, do, ids


def unmasked(ids, causal):
    """``(b, s, s)`` bool: the (query, key) pairs that segment ids ``ids``
    (both sides) and ``causal`` leave to compute."""
    keep = ids[:, :, None] == ids[:, None, :]
    return keep.tril() if causal else keep


def flash_work(q, k, v, do, ids, causal, o, lse, di):
    """``{kernel: (call, ops, nbytes)}`` of F1, F2 and F3 on one input
    (``o``, ``lse`` and ``di`` from F1): a call of the wrapper, the
    operations of its products over the unmasked pairs (2, 4 and 3
    products of 2 d operations per pair and head) and the bytes it must
    move (each input read once, each output written once)."""
    from fewbit_tpu_torch.ops import kernels as K

    d = q.shape[-1]
    pair_ops = 2 * d * q.shape[1] * int(unmasked(ids, causal).sum())
    scale = d ** -0.5
    fargs = (q, k, v, ids, ids, causal, scale)
    bargs = (q, k, v, ids, ids, lse, do, di, causal, scale)

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    return {
        "flash_forward": (lambda: K.flash_forward(*fargs), 2 * pair_ops,
                          nbytes(q, k, v, ids, ids, o, lse)),
        "flash_backward_dkv": (lambda: K.flash_backward_dkv(*bargs),
                               4 * pair_ops,
                               nbytes(q, k, v, ids, ids, lse, do, di, k, v)),
        "flash_backward_dq": (lambda: K.flash_backward_dq(*bargs),
                              3 * pair_ops,
                              nbytes(q, k, v, ids, ids, lse, do, di, q)),
    }


def sdpa_calls(ins, do, scale, kwargs):
    """``(forward, backward)``: calls of PyTorch's
    ``scaled_dot_product_attention`` on ``ins`` (q, k and v that require
    their gradients) with ``kwargs`` (``is_causal`` or ``attn_mask``), the
    backward giving dq, dk and dv in one call against ``do``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    def forward():
        with torch.no_grad():
            return sdpa(*ins, scale=scale, **kwargs)

    out = sdpa(*ins, scale=scale, **kwargs)

    def backward():
        torch.autograd.grad(out, ins, do, retain_graph=True)

    return forward, backward


def sdpa_backend(ins, scale, kwargs):
    """The name of the backend ``scaled_dot_product_attention``'s dispatch
    takes for these arguments, or why it could not be read."""
    from torch.nn.attention import SDPBackend

    try:
        choice = torch._fused_sdp_choice(
            *ins, attn_mask=kwargs.get("attn_mask"),
            is_causal=kwargs.get("is_causal", False), scale=scale)
        return SDPBackend(choice).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not read: {type(e).__name__}"


def sdpa_backend_times(ins, do, scale, kwargs, time_fn):
    """``{backend: {"forward": ms, "backward": ms}}`` for each backend of
    ``scaled_dot_product_attention`` under ``sdpa_kernel`` (flash,
    efficient, cuDNN, math), ``time_fn(call, part)`` timing a call of
    ``part`` (``"forward"`` or ``"backward"``); a backend that refuses the
    call is ``{"refused": its error's first line}``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    got = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                calls = sdpa_calls(ins, do, scale, kwargs)
                got[backend.name] = {
                    part: time_fn(call, part)
                    for part, call in zip(("forward", "backward"), calls)}
                del calls
        except RuntimeError as e:
            got[backend.name] = {"refused": str(e).splitlines()[0][:160]}
        torch.cuda.empty_cache()
    return got


def library_time(q, k, v, do, ids, causal, floors, reps=REPS, tries=3):
    """``{"forward", "backward", "backend", "backends"}``: the device ms
    of PyTorch's ``scaled_dot_product_attention`` on the flash kernels'
    inputs, its backward giving dq, dk and dv in one call; ``floors`` the
    two bounds (``act_timing.device_time``); the backend its dispatch
    takes and each backend's times (:func:`sdpa_backend_times`).  Causal
    cases pass ``is_causal``, the others the padding mask as a boolean
    ``attn_mask``."""
    from fewbit_tpu_torch.tools.act_timing import device_time

    scale = q.shape[-1] ** -0.5
    kwargs = ({"is_causal": True} if causal
              else {"attn_mask": unmasked(ids, False)[:, None]})
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    floor = dict(zip(("forward", "backward"), floors))

    def timed(call, part):
        return device_time(call, reps, tries, bound_ms=floor[part])[0]

    forward, backward = sdpa_calls(ins, do, scale, kwargs)
    got = {"forward": timed(forward, "forward"),
           "backward": timed(backward, "backward"),
           "backend": sdpa_backend(ins, scale, kwargs)}
    del forward, backward
    got["backends"] = sdpa_backend_times(ins, do, scale, kwargs, timed)
    return got


def time_case(b, h, s, d, mode, dtype, reps=REPS, tries=3, library=False):
    """``{kernel: {"device_ms", "source", "bound_ms", "bound_share"}}`` of
    F1, F2 and F3 on one case (:func:`flash_work`); with ``library`` also
    ``{"library": library_time(...)}``."""
    from fewbit_tpu_torch.ops import kernels as K
    from fewbit_tpu_torch.tools.act_timing import device_time
    from fewbit_tpu_torch.tools.timing import bound_ms

    causal = mode == "causal"
    q, k, v, do, ids = _inputs(b, h, s, d, mode, dtype)
    o, lse = K.flash_forward(q, k, v, ids, ids, causal, d ** -0.5)
    di = (o.float() * do.float()).sum(-1)
    rate = "f32" if dtype == torch.float32 else "bf16"
    out = {}
    for name, (fn, ops, nbytes) in flash_work(q, k, v, do, ids, causal, o,
                                              lse, di).items():
        least, by = bound_ms(ops, rate, nbytes)
        ms, source = device_time(fn, reps, tries, bound_ms=least)
        out[name] = {"device_ms": ms, "source": source, "bound_ms": least,
                     "bound_by": by, "bound_share": least / ms}
    if library:
        floors = (out["flash_forward"]["bound_ms"],
                  max(out["flash_backward_dkv"]["bound_ms"],
                      out["flash_backward_dq"]["bound_ms"]))
        out["library"] = library_time(q, k, v, do, ids, causal, floors,
                                      reps, tries)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", nargs=5, action="append",
                    metavar=("B", "H", "S", "D", "MODE"))
    ap.add_argument("--wide", action="store_true",
                    help="time WIDE_CASES (after any --case)")
    ap.add_argument("--library", action="store_true",
                    help="also time scaled_dot_product_attention")
    ap.add_argument("--dtypes", nargs="+", default=["f32", "bf16"],
                    choices=sorted(_DTYPES))
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--tries", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(int(b), int(h), int(s), int(d), mode)
             for b, h, s, d, mode in args.case or ()]
    if args.wide:
        cases += WIDE_CASES
    cases = cases or DEFAULT_CASES
    rows = []
    for case in cases:
        if case[4] not in ("causal", "padded"):
            ap.error(f"mode {case[4]!r}: causal or padded")
        for tag in args.dtypes:
            row = {"case": list(case), "dtype": tag,
                   "device": torch.cuda.get_device_name(0),
                   **time_case(*case, _DTYPES[tag], args.reps, args.tries,
                               args.library)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()

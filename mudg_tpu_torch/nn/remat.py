"""Selective recompute (remat) of the UNet's blocks: the nine policies of
`mudg_tpu/nn/unet3d.py:344-406` and the named sites they read.

The JAX package tags values with `checkpoint_name` and runs each UNet block
under `jax.checkpoint(policy=...)`: the backward replay keeps the tagged
values a policy names and, with XLA's dead-code elimination, recomputes only
what the backward still needs. Eager PyTorch has no such elimination, so the
port keeps the work behind a kept value instead of the value alone:

  * every tag site of the JAX package runs inside `site(name)` (ATen ops) or
    is a kernel op (`kernel_outputs`);
  * a block runs under `torch.utils.checkpoint`; in a block whose policy
    keeps a site's name, the site's ops run under the `_Keep` dispatch mode,
    which saves the outputs of the ops that make the value: the products
    (mm, addmm, bmm, baddbmm, convolution) of a product site (mm_out,
    conv_out, tconv_out, ff_inner), the statistics (the reductions and
    native_layer_norm) of a norm site (gn_out, ln_out), and the residual
    add of a block site (blk_attn1, blk_attn2, blk_ff); the replay returns
    them and reruns the rest, so autograd rebuilds the graph as before and
    the gradients are remat=False's bit for bit (a GroupNorm run as one op
    with its own backward would sum a gradient's terms in another order).
    Ops outside kept sites never pass through Python dispatch (torch's
    selective-checkpoint contexts put every op of the block through it,
    which made the selective policies slower than full recompute; PERF.md
    §6);
  * a kernel op (kernels 2, 3, 5, 11 and 12's autograd ops, launched through
    ctypes, out of the dispatcher's sight) keeps its outputs in the block's
    saved queue when the policy keeps the values they carry, and in the
    replay returns them without launching its forward: kernel 5 when attn_o
    and attn_lse are kept, kernel 2 when attn_h1 and attn_o (or blk_attn2,
    its output) are, kernel 3 when blk_ff (which its output makes) is,
    kernel 11's GroupNorm when gn_out is. These are the forwards the JAX
    replay drops (counted from the gradient's jaxpr,
    tests/test_torch_remat.py).

`dots` (JAX's dots_with_no_batch_dims_saveable) saves every mm and addmm,
products without batch dimensions, of the product sites; `except_ff` saves
every op's output and every kernel op's but those of the ff_inner sites
(its mode spans the block);
`full` (remat=True) saves nothing. The forward hooks of a module that
`exempt_hooks` names (FSDP2's gathers and reshards) keep nothing: they run
in a block's forward but not alike in its replay. Every policy gives remat=False's values:
a policy changes memory and time, never what is computed.
"""
from __future__ import annotations

import collections
import contextlib

import torch
import torch.utils.checkpoint as CK
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

BLOCK_TAGS = ("blk_attn1", "blk_attn2", "blk_ff")
# the save sets of mudg_tpu/nn/unet3d.py:360-402
POLICIES = {
    "full": None,
    "dots": "dots",
    "dots_small": ("mm_out", "conv_out", "tconv_out", *BLOCK_TAGS),
    "dots_ln": ("mm_out", "conv_out", "tconv_out", "gn_out", "ln_out", *BLOCK_TAGS),
    "dots_attn": ("mm_out", "conv_out", "tconv_out", "gn_out", "ln_out",
                  "attn_o", "attn_lse", "attn_h1", *BLOCK_TAGS),
    "except_ff": "except_ff",
    "dots_gn": ("mm_out", "conv_out", "tconv_out", "gn_out", *BLOCK_TAGS),
    "convs": ("conv_out", "tconv_out", *BLOCK_TAGS),
    "names": BLOCK_TAGS,
}

_aten = torch.ops.aten
PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution}
DOTS = {_aten.mm, _aten.addmm}
STATS = {_aten.sum, _aten.mean, _aten.var, _aten.var_mean, _aten.native_layer_norm}
# the ops a kept site saves (None: every op returning no alias)
SITE_OPS = {"mm_out": PRODUCTS, "conv_out": PRODUCTS, "tconv_out": PRODUCTS,
            "ff_inner": PRODUCTS, "gn_out": STATS, "ln_out": STATS,
            **dict.fromkeys(BLOCK_TAGS)}

_scopes: list[str] = []      # the tag sites the running op is inside, innermost last
_block = None                # the running block's _Block, when it has a selective policy
_record = None               # tag counts per block, while `record` runs
_counts = None               # the running block's Counter under `record`
_in_hooks = False            # an `exempt_hooks` module's forward hooks are running


def policy_names(remat):
    """remat (False, True, "full" or a policy name) -> None for full
    recompute, else the policy's save set or rule."""
    if remat is True or remat == "full":
        return None
    if remat not in POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; one of {sorted(POLICIES)}")
    return POLICIES[remat]


def _keeps(rule, groups) -> bool:
    """Whether a policy keeps a kernel op's outputs: every group of
    alternative tag names has one the policy names."""
    if rule == "except_ff":
        return True
    if rule == "dots" or not groups:
        return False
    return all(any(n in rule for n in alts) for alts in groups)


def _no_alias(func) -> bool:
    return not any(r.alias_info is not None for r in func._schema.returns)


class _Block:
    """One checkpointed block call under a selective policy: its policy,
    the outputs its kept ops and kernel ops saved, in call order, and
    whether it is in its forward or its replay."""

    def __init__(self, rule):
        self.rule = rule
        self.saved = collections.deque()
        self.replay = False

    @contextlib.contextmanager
    def _entered(self, replay):
        global _block
        prev = _block
        _block, self.replay = self, replay
        try:
            if self.rule == "except_ff":
                with _Keep(self, None):
                    yield
            else:
                yield
        finally:
            _block = prev

    def contexts(self):
        return self._entered(False), self._entered(True)


class _Keep(TorchDispatchMode):
    """Inside a kept site (or, under except_ff, the whole block): each op
    that `ops` names (None: every op that returns no alias of an input)
    saves its outputs in the forward; in the replay it returns them
    instead of running, while autograd records it as before. An in-place
    change of a saved output between the forward and the replay raises."""

    def __init__(self, blk, ops):
        super().__init__()
        self.blk, self.ops = blk, ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _in_hooks or func.namespace == "profiler":
            # the profiler's ranges (the program's spans) open in the replay too
            return func(*args, **kwargs)
        if self.ops is None:
            keep = _no_alias(func) and "ff_inner" not in _scopes
        else:
            keep = func.overloadpacket in self.ops
        if not keep:
            return func(*args, **kwargs)
        blk = self.blk
        if blk.replay:
            out, versions = blk.saved.popleft()
            if versions != [t._version for t in _tensors(out)]:
                raise RuntimeError(f"remat: an output of {func} kept for the replay "
                                   "was changed in place")
            return out
        out = func(*args, **kwargs)
        kept = _detached(out)
        blk.saved.append((kept, [t._version for t in _tensors(kept)]))
        return out


def _tensors(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor)]


def _detached(out):
    if isinstance(out, (tuple, list)):
        return type(out)(t.detach() if isinstance(t, torch.Tensor) else t for t in out)
    return out.detach() if isinstance(out, torch.Tensor) else out


def _set_in_hooks(value):
    def hook(*_):
        global _in_hooks
        _in_hooks = value
    return hook


def exempt_hooks(module):
    """Keep the ops of the forward hooks that `module` has now out of every
    keep mode. FSDP2's pre-forward hook all-gathers a unit's parameters in
    a block's forward, but in the replay either gathers again or finds them
    gathered by its pre-backward hook; its post-forward hook reshards only
    in the forward. The hooks registered here bracket them."""
    module.register_forward_pre_hook(_set_in_hooks(True), prepend=True)
    module.register_forward_pre_hook(_set_in_hooks(False))
    module.register_forward_hook(_set_in_hooks(True), prepend=True)
    module.register_forward_hook(_set_in_hooks(False), always_call=True)


def checkpoint(fn, *args, remat=True):
    """fn(*args) under torch.utils.checkpoint with the policy `remat`
    (True or "full": everything recomputed)."""
    rule = policy_names(remat)
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if rule is not None and torch.is_grad_enabled():
        kw["context_fn"] = _Block(rule).contexts
    return CK.checkpoint(fn, *args, **kw)


@contextlib.contextmanager
def site(name: str):
    """A JAX tag site (`checkpoint_name(y, name)` on the value the block's
    ops make here). In a block whose policy keeps `name`, its ops run under
    `_Keep`."""
    if _counts is not None:
        _counts[name] += 1
    _scopes.append(name)
    blk = _block
    try:
        if blk is None or blk.rule == "except_ff":
            yield
        elif blk.rule == "dots":
            if name in SITE_OPS and SITE_OPS[name] is PRODUCTS:
                with _Keep(blk, DOTS):
                    yield
            else:
                yield
        elif name in blk.rule and name in SITE_OPS:
            with _Keep(blk, SITE_OPS[name]):
                yield
        else:
            yield
    finally:
        _scopes.pop()


def tag(*names):
    """Count the tags of a kernel op's outputs (`record`); the op itself
    keeps them with `kernel_outputs`."""
    if _counts is not None:
        for n in names:
            _counts[n] += 1


def kernel_outputs(groups, launch):
    """launch() -> a tuple of tensors, the forward of a kernel op called
    inside its autograd.Function. In a block whose policy keeps `groups`
    (alternatives of tag names, see `_keeps`), the forward saves the
    outputs and the replay returns them without calling launch. The
    kernel's own ATen ops run out of any `_Keep` mode's sight."""
    blk = _block
    if blk is None:
        return launch()
    keep = _keeps(blk.rule, groups)
    if keep and blk.replay:
        return blk.saved.popleft()[0]
    with _disable_current_modes():
        out = launch()
    if keep:
        blk.saved.append((tuple(t.detach() for t in out), None))
    return out


@contextlib.contextmanager
def record():
    """Count the tags of each checkpointed block's forward (`block`):
    yields the list of per-block Counters."""
    global _record
    prev, _record = _record, []
    try:
        yield _record
    finally:
        _record = prev


@contextlib.contextmanager
def block():
    """A checkpointed UNet block's forward, for `record`: its tags go to a
    Counter of their own. Tags outside such a block are not counted, as the
    JAX trace has no checkpoint around them."""
    global _counts
    if _record is None:
        yield
        return
    prev, _counts = _counts, collections.Counter()
    _record.append(_counts)
    try:
        yield
    finally:
        _counts = prev

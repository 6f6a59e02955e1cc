"""Taps: what the benchmark records from the program while the window
runs, from outside it. Each tap wraps one module attribute of the
program for the length of a `with` block and puts the original back
after it:

- `Solves`: window solves (the program's `solve_window_core`), one of
  each kind drawn from the seed as they arrive: the inputs and the
  answer, copied on the device without a host sync;
- `PnP`: camera-rate PnP refines (`refine_pose_pnp`), a few drawn alike;
- `Marginalizations`: marginalizations (`marginalize_frame`), a few
  drawn alike: the window, the victim and the prior that came out;
- `KernelCalls`: the shapes of each K1 and K2 call (`klt.track_keypoints`,
  `gram.reproj_factor_gram`), host values only, for the rooflines, and
  the K1 calls of chosen frames whole: the two pyramids, the points and
  the answer;
- `Spans`: the program's stage timers (`StageTimes.stage`) as host
  spans, each tagged with the frame being driven.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


def _tensors(nt) -> dict:
    """A NamedTuple of tensors (nested ones too) as a dict of detached
    copies."""
    out = {}
    for k, v in nt._asdict().items():
        out[k] = _tensors(v) if hasattr(v, "_asdict") else v.detach().clone()
    return out


@contextlib.contextmanager
def patched(module, name: str, wrapper):
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


class Reservoir:
    """Up to `k` calls of each kind, drawn at random from the seed's
    generator as they arrive (algorithm R): a call is copied only when
    it is kept, so the window pays for a few copies, not one a call."""

    def __init__(self, rng, k: int):
        self.rng = rng
        self.k = k
        self.seen = {}
        self.kept = {}

    def offer(self, kind, copy) -> None:
        n = self.seen.get(kind, 0)
        self.seen[kind] = n + 1
        kept = self.kept.setdefault(kind, [])
        if n < self.k:
            kept.append(copy())
        else:
            j = int(self.rng.integers(n + 1))
            if j < self.k:
                kept[j] = copy()

    def calls(self, kinds: int) -> list:
        """The kept calls of the `kinds` most frequent kinds."""
        order = sorted(self.seen, key=self.seen.get, reverse=True)[:kinds]
        return [c for kind in order for c in self.kept[kind]]

    @property
    def count(self) -> int:
        return sum(self.seen.values())


def _split_marg(data) -> dict:
    d = _tensors(data)
    m = d.pop("marg")
    d.update(marg_U=m["sqrt_inv_cov"], marg_infovec=m["infovec"], marg_lin=m["lin"])
    return d


class Solves(Reservoir):
    """Window solves: one (state, data, options, answer) of each kind
    (frame count, rotation mode, iteration count), the options as plain
    values. The program's solve is a pure function of its tensors, so
    copies taken at the call are what it solved."""

    frame = None

    def __init__(self, rng):
        super().__init__(rng, 1)

    def __call__(self, orig):
        def solve(state, data, opts, *args, **kwargs):
            out = orig(state, data, opts, *args, **kwargs)
            o = dataclasses.asdict(opts)
            self.offer((tuple(state.q.shape), bool(o["use_rotation"]), o["iterations"]),
                       lambda: dict(frame=self.frame, state=_tensors(state),
                                    data=_split_marg(data), opts=o, out=_tensors(out[0])))
            return out
        return solve


class PnP(Reservoir):
    """Camera-rate PnP refines: arguments and answer of `k` calls."""

    frame = None

    def __call__(self, orig):
        def refine(q_wc, p_wc, X, bearings, valid, sqrt_inv_cov2, iters=10, **kw):
            q, p = orig(q_wc, p_wc, X, bearings, valid, sqrt_inv_cov2, iters=iters, **kw)
            self.offer("pnp", lambda: dict(
                frame=self.frame, args=[t.detach().clone() for t in
                                        (q_wc, p_wc, X, bearings, valid, sqrt_inv_cov2)],
                iters=iters, kw=dict(kw), out=(q.detach().clone(), p.detach().clone())))
            return q, p
        return refine


class Marginalizations(Reservoir):
    """Marginalizations (`marginalize_frame`) of `k` calls: the window
    and the victim, and the prior that came out."""

    frame = None

    def __call__(self, orig):
        def marg(state, data, victim=0, **kw):
            out = orig(state, data, victim=victim, **kw)
            self.offer("marg", lambda: dict(
                frame=self.frame, state=_tensors(state), data=_split_marg(data),
                victim=victim, kw=dict(kw),
                out=(out.sqrt_inv_cov.detach().clone(), out.infovec.detach().clone())))
            return out
        return marg


class KernelCalls:
    """K1 (`klt.track_keypoints`) and K2 (`gram.reproj_factor_gram`):
    the shapes of each call while `on`, host values only, for the
    rooflines; and K1's calls in the frames of `track_at` whole (the
    pyramids, the points, the seeds, the valid slots and the answer)
    for the check."""

    def __init__(self, track_at=()):
        self.track_at = set(track_at)
        self.tracks = []
        self.k1 = []
        self.k2 = []
        self.on = False
        self.frame = None

    def klt(self, orig):
        def track(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, *args, **kw):
            if self.on:
                self.k1.append(dict(levels=[tuple(x.shape) for x in prev_pyr],
                                    slots=int(pts_prev.shape[0]),
                                    win=kw.get("win", 21)))
            out = orig(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, *args, **kw)
            if self.frame in self.track_at:
                self.tracks.append(dict(
                    frame=self.frame, prev_pyr=[x.detach().clone() for x in prev_pyr],
                    next_pyr=[x.detach().clone() for x in next_pyr],
                    pts=pts_prev.detach().clone(), init=pts_init.detach().clone(),
                    valid=valid_in.detach().clone(), kw=dict(kw),
                    out=(out[0].detach().clone(), out[1].detach().clone())))
            return out
        return track

    def gram(self, orig):
        def gram(state, data):
            if self.on:
                self.k2.append(dict(N=1 if state.q.dim() == 2 else int(state.q.shape[0]),
                                    K=int(state.q.shape[-2]),
                                    L=int(state.inv_depth.shape[-1]),
                                    itemsize=state.p.element_size()))
            return orig(state, data)
        return gram


class Spans:
    """The program's stage timers as (name, frame, start_ns, end_ns)
    spans on the host clock (time.perf_counter_ns)."""

    def __init__(self):
        self.spans = []
        self.frame = None

    def install(self, times):
        orig = times.stage
        spans = self.spans

        @contextlib.contextmanager
        def stage(name):
            t0 = time.perf_counter_ns()
            with orig(name):
                yield
            spans.append((name, self.frame, t0, time.perf_counter_ns()))

        times.stage = stage

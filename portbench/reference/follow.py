"""The reference side of a cell's check: build the frozen plain copy
(``mgref``) from the configuration file and the traffic file, follow what
the program's timed path produced, and put the reference in the program's
place for the control and the planted faults.

Everything here runs eagerly, the policy in the configuration's dtype (the
reference; float32 products with TF32 off), or with every operand of the
policy's products rounded to fp8 first (the control).
"""
from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

from . import cli
from .mgref.core import obs as obs_mod, rng, step as step_mod
from .mgref.parallel import ppo, ppo_rnn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
GRAD8 = torch.float8_e5m2
GRAD8_MAX = 57344.0


def build(config: dict, traffic: dict, seed: int = 0):
    """``(EnvParams, PPOConfig)`` of the configuration at the traffic's
    batch and length: the same argv the program's parser reads
    (``cli.cli_flags``) through the frozen copy of the train CLI's parser
    and build (``cli.py``), the policy computing in the configuration's
    dtype."""
    args = cli.parse_args(cli.cli_flags(config["args"], traffic, seed))
    return cli.build(args, getattr(torch, config["dtype"]))


def stagger(config: dict) -> bool:
    return config["args"].get("stagger", True)


@contextlib.contextmanager
def plain_float32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _round8(x, dtype, top):
    """``x`` rounded to ``dtype`` under one per-tensor scale that maps its
    largest magnitude to ``top``, and scaled back (float32)."""
    amax = x.detach().abs().max().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """The control's rounding of an operand of a product: e4m3 going
    forward, the gradient e5m2 coming back, each under a per-tensor scale
    (the usual fp8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, FP8, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, GRAD8, GRAD8_MAX)


def fp8(x):
    return _Fp8.apply(x)


def make_net(ep, cfg, weights, device, quant=None):
    """``(net, optimizer, h)`` of the reference with ``weights`` loaded;
    ``quant`` rounds every operand of the policy's products (the control)."""
    gen = torch.Generator().manual_seed(0)
    if cfg.rnn:
        net, opt, h = ppo_rnn.init_state_rnn(ep, cfg, gen, device=device)
    else:
        (net, opt), h = ppo.init_state(ep, cfg, gen, device=device), None
    net.load_state_dict(weights)
    if quant is not None:
        for m in net.modules():
            m.quant = quant
    return net, opt, h


def start(ep, cfg, key, stagger: bool, device):
    """The env batch and the step key of a run, as the train CLI makes them
    from its key: the batch from ``fold_in(key, 1)``, the key
    ``fold_in(key, 2)``."""
    state = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                               stagger=stagger, device=device)
    return state, rng.fold_in(key, 2)


def half_batch_loss(logits, value, lab, cfg):
    """A planted fault: ``ppo.ppo_loss`` with half of the minibatch's
    samples left out and the mean taken over the rest."""
    adv = lab["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

    def mean(x):
        x = x.reshape(-1)
        return x[: x.numel() // 2].mean()

    pg, vf, ent, dev = (mean(x) for x in ppo.ppo_terms(logits, value, lab,
                                                        adv, cfg))
    total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent, ratio_dev=dev)


@contextlib.contextmanager
def planted(fault: str):
    """The reference with a planted fault, for the check of the checks:
    ``half_batch`` (the loss over half of each minibatch)."""
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    saved = ppo.ppo_loss, ppo_rnn.ppo_loss
    ppo.ppo_loss = ppo_rnn.ppo_loss = half_batch_loss
    try:
        yield
    finally:
        ppo.ppo_loss, ppo_rnn.ppo_loss = saved


def adam_state(opt, named):
    """Adam's first moment of each of the ``named`` parameters (float32
    copies by name; zeros where it holds none, never having stepped) and
    its step count."""
    m, steps = {}, 0.0
    for n, p in named:
        st = opt.state.get(p, {})
        m[n] = (st["exp_avg"].detach().float().clone() if "exp_avg" in st
                else torch.zeros_like(p, dtype=torch.float32))
        if "step" in st:
            steps = float(st["step"])
    return m, steps


def _clone_carry(h):
    if h is None:
        return None
    if isinstance(h, tuple):
        return tuple(x.clone() for x in h)
    return h.clone()


def snapshot(net, opt, state, key, h):
    """What a train call starts from: the weights and Adam's state of each
    parameter by name, the env state's fields, the key and the carry
    (copies)."""
    from .mgref.core.state import FIELDS

    named = list(net.named_parameters())
    return dict(
        weights={n: p.detach().clone() for n, p in named},
        opt={n: {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in opt.state[p].items()}
             for n, p in named if p in opt.state},
        state={f: getattr(state, f).clone() for f in FIELDS},
        key=key.clone(), h=_clone_carry(h))


def _step(ep, cfg, net, opt, device):
    if cfg.rnn:
        return ppo_rnn.make_train_step_rnn(ep, cfg, net, opt, device=device)
    return ppo.make_train_step(ep, cfg, net, opt, device=device)


def _call(step, cfg, state, h, key):
    if cfg.rnn:
        return step(state, h, key)
    state, key, m = step(state, key)
    return state, h, key, m


def run_calls(ep, cfg, weights, key, stagger, device, n=3, quant=None):
    """The reference's first ``n`` train steps from the run's inputs, in
    the program's place (the control with ``quant``, or with a planted
    fault): what a run keeps of the program's first calls
    (``loops/train.py``): each call's start (:func:`snapshot`), loss and
    Adam's state after it (:func:`adam_state`), Adam's beta1, and the
    weights after the last (``final``)."""
    net, opt, h = make_net(ep, cfg, weights, device, quant)
    named = list(net.named_parameters())
    state, key = start(ep, cfg, key, stagger, device)
    step = _step(ep, cfg, net, opt, device)
    kept = dict(starts=[], losses=[], adam=[],
                beta1=opt.param_groups[0]["betas"][0])
    for _ in range(n):
        kept["starts"].append(snapshot(net, opt, state, key, h))
        state, h, key, m = _call(step, cfg, state, h, key)
        kept["losses"].append(float(m["loss"]))
        kept["adam"].append(adam_state(opt, named))
    kept["final"] = {n: p.detach().clone() for n, p in named}
    return kept


def follow_calls(ep, cfg, starts, device):
    """One reference train step from each of a run's call starts (the
    program's weights, Adam state, env state, key and carry before that
    call): ``dict(losses, adam, after)``, each step's loss, Adam's state
    after it and the weights after it, by name."""
    from .mgref.core.state import EnvState

    out = dict(losses=[], adam=[], after=[])
    for s in starts:
        net, opt, _ = make_net(ep, cfg, s["weights"], device)
        named = list(net.named_parameters())
        for n, p in named:
            if n in s["opt"]:
                opt.state[p] = {k: v.clone() if torch.is_tensor(v) else v
                                for k, v in s["opt"][n].items()}
        state = EnvState(**{f: v.clone() for f, v in s["state"].items()})
        step = _step(ep, cfg, net, opt, device)
        _, _, _, m = _call(step, cfg, state, _clone_carry(s["h"]),
                           s["key"].clone())
        out["losses"].append(float(m["loss"]))
        out["adam"].append(adam_state(opt, named))
        out["after"].append({n: p.detach().clone() for n, p in named})
    return out


def rollout_call(ep, cfg, net, state, key, device):
    """One acting call of the reference (``ppo.make_rollout``), for the
    control in the program's place: ``(state, key, traj)``."""
    rollout = ppo.make_rollout(ep, cfg, net, device=device)
    state, key, traj, _ = rollout(state, key)
    return state, key, traj


@torch.no_grad()
def follow_rollout(ep, cfg, net, state, key, traj, device):
    """Follow one acting call of the program from ``state`` and ``key``
    with the program's own actions: at each step the reference renders the
    observation and compares it with the program's, evaluates its policy on
    the program's observation, draws the Gumbel noise of the step's key,
    and steps its env with the program's actions, comparing rewards and
    dones. Returns ``(state, key, readings)``: the envs whose observation,
    reward or done differ (``env_mismatch``, summed over steps), the widest
    gap by which the program's action's perturbed logit lies below the
    reference's best (``sample_gap``), and the widest gaps of the action's
    log-probability and of the value (``logp_gap``, ``value_gap``)."""
    B, T, N = cfg.n_envs, cfg.rollout_len, ep.n_agents
    Fd = 3 * ep.view_size ** 2
    K = ppo.pool_size(cfg, B)
    ks = rng.split(key)
    key, fk = ks[0], ks[1]
    pool = step_mod.fresh_pool(ep, fk, K)
    mis = torch.zeros((), dtype=torch.int64, device=device)
    gaps = torch.zeros(3, device=device)
    for t in range(T):
        bm = obs_mod.all_agent_obs_b(ep, state, bminor=True)
        mine = bm.permute(1, 0, 2, 3, 4).reshape(N, Fd, B).to(torch.uint8)
        theirs = traj["obs"][t]
        mis += (mine != theirs).any(0).any(0).sum()
        logits, value = net(theirs)
        ks = rng.split(key)
        key, ak = ks[0], ks[1]
        pert = logits + rng.gumbel(ak, logits.shape)
        a = traj["act"][t].long()                          # (N, B)
        gap = pert.max(-1).values - pert.gather(-1, a[..., None])[..., 0]
        logp = F.log_softmax(logits, -1).gather(-1, a[..., None])[..., 0]
        gaps = torch.maximum(gaps, torch.stack([
            gap.max(), (logp - traj["logp"][t]).abs().max(),
            (value - traj["val"][t]).abs().max()]))
        fresh_t = step_mod.fresh_pool_rows(pool, t, 0, B)
        state, rew, done, _ = step_mod.step_autoreset_with_fresh_batch(
            ep, state, a.T, fresh_t, env_offset=0, salt=t)
        mis += ((rew.T != traj["rew"][t]).any(0)
                | (done != traj["done"][t])).sum()
    sample, logp, value = gaps.tolist()
    return state, key, dict(env_mismatch=int(mis), sample_gap=sample,
                            logp_gap=logp, value_gap=value)


def ref_state(state):
    """The reference's EnvState of another EnvState's fields."""
    from .mgref.core.state import FIELDS, EnvState

    return EnvState(**{f: getattr(state, f) for f in FIELDS})


def state_mismatch(a, b) -> int:
    """Envs whose state differs in any field between two EnvStates."""
    from .mgref.core.state import FIELDS

    bad = None
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        d = (x != y).reshape(x.shape[0], -1).any(1)
        bad = d if bad is None else bad | d
    return int(bad.sum())


def leaf_gap(mine, ref, keep):
    """The worst leaf's gap between two per-leaf norms, over the leaves
    ``keep`` selects: ``|‖mine‖ - ‖ref‖|`` against the larger of the
    reference leaf's norm and the median leaf's."""
    nm = torch.stack([x.norm() for x in mine])
    nr = torch.stack([x.norm() for x in ref])
    med = nr[keep].median()
    return float(((nm - nr).abs() / torch.maximum(nr, med))[keep].max())


def _moment(start, name, like):
    """Adam's first moment of ``name`` at a call's start, and its step
    count (zeros and 0 where it never stepped)."""
    st = start["opt"].get(name, {})
    m = (st["exp_avg"].float() if "exp_avg" in st
         else torch.zeros_like(like, dtype=torch.float32))
    return m, float(st["step"]) if "step" in st else 0.0


def _keep(ref_leaves):
    """The leaves a gap is taken over: those whose reference norm is at
    least a thousandth of the median leaf's (a gradient that is nought to
    rounding moves under Adam by round-off alone)."""
    nr = torch.stack([x.norm() for x in ref_leaves])
    return nr >= 1e-3 * nr.median()


def train_readings(prog: dict, ref: dict) -> dict:
    """The numbers a train cell compares, each call against the reference's
    step from the same start (``prog`` as :func:`run_calls` keeps it,
    ``ref`` as :func:`follow_calls` gives it): the widest loss gap
    (``loss_gap``); by the worst leaf, the gap of the call's own gradients
    as Adam got them, ``m_after - beta1 ** (its steps) * m_start`` (the
    clipped minibatch gradients, each weighted by ``(1 - beta1) * beta1 **
    (steps after it in the call)``), the widest over the calls
    (``grad_gap``; each call's as ``grad_gap.call<k>``: call 0 is the eager
    call, the later ones graph replays); and the same of the weights'
    change over the call (``change_gap``, ``change_gap.call<k>``)."""
    b1 = prog["beta1"]
    n = len(prog["starts"])
    after = [prog["starts"][k + 1]["weights"] for k in range(n - 1)]
    after.append(prog["final"])
    out = dict(loss_gap=max(abs(a - b) for a, b in zip(prog["losses"],
                                                         ref["losses"])))
    for k, start in enumerate(prog["starts"]):
        names = list(ref["adam"][k][0])
        mine, theirs, dw_mine, dw_ref = [], [], [], []
        for name in names:
            w = start["weights"][name].float()
            m0, s0 = _moment(start, name, w)
            for side, (m, steps) in ((mine, prog["adam"][k]),
                                     (theirs, ref["adam"][k])):
                side.append(m[name] - b1 ** (steps - s0) * m0)
            dw_mine.append(after[k][name].float() - w)
            dw_ref.append(ref["after"][k][name].float() - w)
        keep = _keep(theirs)
        out[f"grad_gap.call{k}"] = leaf_gap(mine, theirs, keep)
        out[f"change_gap.call{k}"] = leaf_gap(dw_mine, dw_ref, keep)
    for what in ("grad_gap", "change_gap"):
        out[what] = max(out[f"{what}.call{k}"] for k in range(n))
    return out


def start_mismatch(ep, cfg, prog: dict, weights: dict, key, stagger,
                   device) -> int:
    """What of the program's first call's start differs from the run's
    inputs and the start the reference makes of them itself (the state
    the later calls' checks take from the program): envs whose state
    differs, a key that differs, and leaves that are not the run's
    weights."""
    from .mgref.core.state import EnvState

    s = prog["starts"][0]
    state, key = start(ep, cfg, key, stagger, device)
    theirs = EnvState(**s["state"])
    bad = state_mismatch(state, theirs) + int(not torch.equal(key, s["key"]))
    return bad + sum(int(not torch.equal(w, s["weights"][n]))
                     for n, w in weights.items())

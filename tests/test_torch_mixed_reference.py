"""The benchmark's plain reference of the mixed-style trainer
(``portbench/reference/mixed.py`` and ``mgref/parallel/ppo_hetero*.py``)
against the port's eager step, on the CPU; the style stages the port's
mixed step runs in; the arithmetic of the mixed cell's readers.

The configuration is the benchmark's ``goal_cycle_mixed_styles`` (2 encode
+ 2 image agents, goal_cycle 13x13, hidden 128, 2 epochs x 4 minibatches)
at B 8, T 4, computing in float32, from the weights the benchmark makes of
a seed (``inputs.make_weights``).
"""
import ast
import contextlib
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import FIELDS
from marlgrid_tpu_torch.parallel import ppo, ppo_hetero_mixed, train
from marlgrid_tpu_torch.utils import profiling
from portbench import flops, harness, inputs, roofline, stages, styles
from portbench.loops import train_mixed
from portbench.reference import cli, follow, mixed
from portbench.reference.mgref.parallel import ppo as ref_ppo
from portbench.reference.mgref.parallel import ppo_hetero as ref_hetero

ROOT = Path(__file__).resolve().parents[1]
CELL = "train.goal_cycle_mixed_styles"
TINY = {"envs": 8, "rollout": 4}
SEED = 2 ** 33 + 12_345
#: float32 on one thread: both sides run the same products in the same
#: order and read 0 gaps at this size. The tolerances leave room for a sum
#: taken in another order (a few float32 ulps, which Adam can turn into a
#: sign where a gradient is near 0, as ``test_torch_ppo_hetero_mixed.py``
#: shows against JAX), relative to each leaf's largest value; one group's
#: loss halved reads 0.04 in the loss and 0.007 or more in the gradients.
LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-6, 5e-5, 5e-5
#: the PPOConfig fields both builds set from the flags
SAME = ("n_envs", "rollout_len", "lr", "torso", "n_epochs", "n_minibatches",
        "hidden", "board_pool", "rnn", "dtype", "embed_palettes")


@pytest.fixture(scope="module")
def config():
    _, conf, traffic, *_ = harness.load(ROOT / "BENCHMARK.json", CELL)
    return dict(conf, dtype="float32"), dict(traffic, **TINY)


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def port_build(config, traffic):
    ep, cfg = train.build(train.parse_args(cli.cli_flags(
        config["args"], traffic, SEED)))
    return ep, dataclasses.replace(cfg, dtype=torch.float32)


def start(config, traffic, ep, cfg):
    key = inputs.make_key(SEED, "cpu")
    state = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                               device="cpu")
    return state, rng.fold_in(key, 2)


def halve_group(g):
    """The reference's union loss with group ``g``'s terms halved: the
    fault the comparison has to see."""
    def loss(parts, cfg):
        advs = [lab["adv"] for _, _, lab in parts]
        n = sum(a.numel() for a in advs)
        mean = sum(a.sum() for a in advs) / n
        std = torch.sqrt(sum(((a - mean) ** 2).sum() for a in advs) / n)
        sums = [0.0] * 4
        for i, (logits, value, lab) in enumerate(parts):
            terms = ref_ppo.ppo_terms(logits, value, lab,
                                      (lab["adv"] - mean) / (std + 1e-8), cfg)
            sums = [s + x.sum() * (0.5 if i == g else 1.0)
                    for s, x in zip(sums, terms)]
        pg, vf, ent, dev = (s / n for s in sums)
        total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
        return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent,
                           ratio_dev=dev)
    return loss


def per_group(a, b, names):
    """The widest gap between the leaves of ``a`` and ``b`` of each group
    (the leaves' names start with the group's index), each against its
    leaf's largest magnitude."""
    out = {}
    for n in names:
        gap = ((a[n] - b[n]).abs().max()
               / b[n].abs().max().clamp(min=1e-12)).item()
        g = n.split(".")[0]
        out[g] = max(out.get(g, 0.0), gap)
    return out


def one_step(config, traffic, monkeypatch, fault=None):
    """One eager train step of the port and of the reference from the same
    start: the losses, each leaf's first moment (the gradients as Adam got
    them) and its change, by group; the starts' mismatch."""
    ep, cfg = port_build(config, traffic)
    w = train_mixed.weights(config, traffic, SEED, "cpu")
    nets, opt = ppo_hetero_mixed.init_state_hetero_mixed(
        ep, cfg, torch.Generator().manual_seed(0), device="cpu")
    nets.load_state_dict(w)
    state, key = start(config, traffic, ep, cfg)
    rep, rcfg = mixed.build(config, traffic, SEED)
    assert rep.to_dict() == ep.to_dict()
    assert {f: getattr(rcfg, f) for f in SAME} == {f: getattr(cfg, f)
                                                   for f in SAME}
    rnets, ropt = mixed.make_net(rep, rcfg, w, "cpu")
    rstate, rkey = follow.start(rep, rcfg, inputs.make_key(SEED, "cpu"),
                                True, "cpu")
    mismatch = follow.state_mismatch(state, rstate) + int(
        not torch.equal(key, rkey))
    if fault is not None:
        monkeypatch.setattr(ref_hetero, "group_loss", fault)
    with one_thread():
        step = ppo_hetero_mixed.make_train_step_hetero_mixed(
            ep, cfg, nets, opt, device="cpu", jit=False)
        _, _, m = step(state, key)
        rstep = mixed._step(rep, rcfg, rnets, ropt, "cpu")
        _, _, rm = rstep(rstate, rkey)
    names = [n for n, _ in nets.named_parameters()]
    mine = follow.adam_state(opt, list(nets.named_parameters()))[0]
    theirs = follow.adam_state(ropt, list(rnets.named_parameters()))[0]
    dw = {n: p.detach() - w[n] for n, p in nets.named_parameters()}
    rdw = {n: p.detach() - w[n] for n, p in rnets.named_parameters()}
    return dict(loss=abs(float(m["loss"]) - float(rm["loss"])),
                grad=per_group(mine, theirs, names),
                change=per_group(dw, rdw, names), mismatch=mismatch)


@pytest.mark.parametrize("fault", [None, 0, 1])
def test_train_step_against_the_reference(config, monkeypatch, fault):
    """The port's eager step follows the reference within the tolerances
    (module constants); with one group's advantages halved in the
    reference's loss (the encode group 0 or the image group 1), the
    comparison fails."""
    gaps = one_step(*config, monkeypatch,
                    None if fault is None else halve_group(fault))
    assert gaps["mismatch"] == 0
    held = (gaps["loss"] <= LOSS_TOL
            and max(gaps["grad"].values()) <= GRAD_TOL
            and max(gaps["change"].values()) <= CHANGE_TOL)
    assert set(gaps["grad"]) == {"0", "1"}
    if fault is None:
        assert held, gaps
    else:
        assert not held and gaps["grad"][str(fault)] > GRAD_TOL, gaps


def test_rollout_against_the_reference(config):
    """The port's eager rollout and the reference's from the same start:
    the same actions, rewards, dones and codes; log-probabilities and
    values to float32 rounding."""
    conf, traffic = config
    ep, cfg = port_build(conf, traffic)
    w = train_mixed.weights(conf, traffic, SEED, "cpu")
    nets, _ = ppo_hetero_mixed.init_state_hetero_mixed(
        ep, cfg, torch.Generator().manual_seed(0), device="cpu")
    nets.load_state_dict(w)
    state, key = start(conf, traffic, ep, cfg)
    rep, rcfg = mixed.build(conf, traffic, SEED)
    rnets, _ = mixed.make_net(rep, rcfg, w, "cpu")
    rstate, rkey = follow.start(rep, rcfg, inputs.make_key(SEED, "cpu"),
                                True, "cpu")
    from portbench.reference.mgref.parallel import ppo_hetero_mixed as ref
    with one_thread():
        out = ppo_hetero_mixed.make_rollout_hetero_mixed(
            ep, cfg, nets, device="cpu")(state, key)
        rout = ref.make_rollout_hetero_mixed(rep, rcfg, rnets,
                                             device="cpu")(rstate, rkey)
    traj, rtraj = out[2], rout[2]
    for k in ("act", "rew", "done", "ep_ret", "ep_len", "ep_cyc"):
        assert torch.equal(traj[k], rtraj[k]), k
    for a, b in zip(traj["obs"], rtraj["obs"]):
        assert (a is None and b is None) or torch.equal(a, b)
    for f in FIELDS:
        assert torch.equal(getattr(traj["state"], f),
                           getattr(rtraj["state"], f)), f
        assert torch.equal(getattr(out[0], f), getattr(rout[0], f)), f
    assert torch.equal(out[1], rout[1])
    for k in ("logp", "val"):
        torch.testing.assert_close(traj[k], rtraj[k], rtol=1e-5, atol=1e-6)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


NEW_FILES = ["portbench/reference/mixed.py",
             "portbench/reference/mgref/parallel/ppo_hetero.py",
             "portbench/reference/mgref/parallel/ppo_hetero_mixed.py",
             "portbench/loops/train_mixed.py"]


@pytest.mark.parametrize("path", NEW_FILES)
def test_imports_nothing_banned(path):
    """The reference imports nothing of JAX or of the port, and the loop
    nothing of JAX or of the port's kernels (it builds the program through
    ``parallel/train.py``, as the CLI does)."""
    names = set(_imports(ROOT / path))
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "marlgrid_tpu"}, names
    if "reference" in path:
        assert "marlgrid_tpu_torch" not in tops, names
    assert not any(n.startswith(("marlgrid_tpu_torch.ops",
                                 "marlgrid_tpu_torch.csrc")) for n in names)


class Paths:
    """A stand-in for the capture's stage recorder: the stage paths the
    step opened, in order."""

    def __init__(self):
        self.stack, self.seen = [()], []

    def enter(self, name):
        self.stack.append(self.stack[-1] + (name,))
        self.seen.append(self.stack[-1])

    def exit(self):
        self.stack.pop()


STYLE_STAGES = {f"{p}.{s}": p for p in ("rollout.obs", "rollout.policy",
                                        "update.forward")
                for s in ("encode", "pixels")}


def test_style_stages_under_their_parents(config):
    """Each group's render and forward run in a style stage under its
    parent, in a recording (as a capture records) and in the profiler's
    view of the eager step on the CPU."""
    conf, traffic = config
    ep, cfg = port_build(conf, dict(traffic, rollout=2))
    nets, opt = ppo_hetero_mixed.init_state_hetero_mixed(
        ep, cfg, torch.Generator().manual_seed(0), device="cpu")
    state, key = start(conf, traffic, ep, cfg)
    step = ppo_hetero_mixed.make_train_step_hetero_mixed(
        ep, cfg, nets, opt, device="cpu", jit=False)
    rec = Paths()
    with profiling.recording(rec):
        state, key, _ = step(state, key)
    for path in rec.seen:
        if path[-1] in STYLE_STAGES:
            assert path[-2] == STYLE_STAGES[path[-1]], path
    assert {p[-1] for p in rec.seen} >= set(STYLE_STAGES)
    assert not any(p[-1].endswith((".encode", ".pixels")) and
                   p[-2].startswith("update.render") for p in rec.seen)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, key)
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    for child, parent in STYLE_STAGES.items():
        assert spans.get(child), child
        for s, e in spans[child]:
            assert any(ps <= s and e <= pe for ps, pe in spans[parent]), \
                child


@pytest.mark.parametrize("cell", ["train.goal_cycle_encode",
                                  "train.social_learning_image_gru"])
def test_shared_policy_steps_open_no_style_stage(cell):
    """The benchmark's shared-policy train steps (feedforward encode, GRU
    image) open the stages they opened before and no style stage, so their
    stage maps are unchanged."""
    _, conf, traffic, *_ = harness.load(ROOT / "BENCHMARK.json", cell)
    ep, cfg = train.build(train.parse_args(cli.cli_flags(
        conf["args"], dict(traffic, envs=8, rollout=2), SEED)))
    net, opt, h = train.init(ep, cfg, torch.Generator().manual_seed(0),
                             "cpu")
    step = train.make_step(ep, cfg, net, opt, "cpu", jit=False)
    key = inputs.make_key(SEED, "cpu")
    state = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                               device="cpu")
    rec = Paths()
    with profiling.recording(rec):
        if cfg.rnn:
            step(state, h, key)
        else:
            step(state, key)
    names = {p[-1] for p in rec.seen}
    assert {"rollout.obs", "rollout.policy", "update.forward"} <= names
    assert not any(n.endswith((".encode", ".pixels")) for n in names)


def mixed_shape():
    """The mixed cell's shape as its loop gives it, at the cell's size."""
    _, conf, traffic, *_ = harness.load(ROOT / "BENCHMARK.json", CELL)
    prog = train_mixed.Program(conf, traffic, 2 ** 31 + 1, "cpu")
    return prog.shape


def test_reader_arithmetic_at_the_cells_size():
    """At B 4096, T 32: the pixel group's K3 work is 41 launches and
    794,624 views a call (33 rollout renders of 2 x 4096, 8 re-renders of
    2 x 32,768); the mixed mfu's operations are the groups' own."""
    shape = mixed_shape()
    assert [(g["style"], g["N"], g["torso"]) for g in shape["groups"]] == [
        ("encode", 2, "mlp"), ("pixels", 2, "cnn_s2d")]
    pix = train_mixed.group_shape(shape, shape["groups"][1])
    k3 = roofline.calls(pix)["k3"]
    assert sum(n for _, n in k3) == 41
    views = (pix["N"] * pix["B"] * (pix["T"] + 1)
             + pix["N"] * pix["T"] * pix["B"] // pix["minibatches"]
             * pix["epochs"] * pix["minibatches"])
    assert views == 794_624
    per_view = roofline.k3_s(1, pix["view"], pix["tile"])
    least = sum(t * n for t, n in k3)
    assert least == pytest.approx(views * per_view, rel=1e-12)
    ops = sum(flops.call_ops(train_mixed.group_shape(shape, g))
              for g in shape["groups"])
    assert ops == flops.call_ops(train_mixed.group_shape(
        shape, shape["groups"][0])) + flops.call_ops(pix)
    read = harness.reader(ROOT / "BENCHMARK.json", "train.mfu.mixed")
    ctx = SimpleNamespace(kind="train", shape=shape, calls=[(0.1, 0.3)] * 7,
                          world=1, window_s=2.5)
    assert read(ctx) == pytest.approx(
        100 * ops * 7 / (roofline.BF16_OPS_PER_S * 2.5), rel=1e-12)
    k3_read = harness.reader(ROOT / "BENCHMARK.json",
                             "k3_roofline.mixed.train")
    trace = SimpleNamespace(calls=1, kernel_s=lambda base: (1e-3, 41))
    ctx = SimpleNamespace(kind="train", shape=shape, trace=trace,
                          launches={"compose_image_b": 41.0})
    assert k3_read(ctx) == pytest.approx(100 * least / 1e-3)
    ctx.launches = {"compose_image_b": 73.0}
    assert k3_read(ctx) is None


class FakeTrace(SimpleNamespace):
    """A trace's ``host`` and ``ops`` (hashable, as the readers cache by
    trace)."""

    __hash__ = object.__hash__


def test_style_readers_on_a_map(monkeypatch):
    """The style readers put each traced op down by the map's stage paths
    (``update.render`` with the pixels), and give no reading for a map
    without style stages (a program from before them)."""
    P = ("step", "rollout")
    paths = [P + ("rollout.obs",), P + ("rollout.obs", "rollout.obs.encode"),
             P + ("rollout.obs", "rollout.obs.pixels"),
             P + ("rollout.policy", "rollout.policy.pixels"),
             ("step", "update", "update.render"),
             ("step", "update", "update.forward", "update.forward.encode"),
             ("step", "update", "update.backward")]
    names = [f"k{i}" for i in range(len(paths))]
    trace = FakeTrace(
        host=[("cudaGraphLaunch", 0, 1)],
        ops=[(f"k{i}", 10 + 100 * i, 10 + 100 * i + 10 * (i + 1))
             for i in range(len(paths))])
    monkeypatch.setattr(stages, "live_map", lambda: (paths, names))
    styles.per_call.cache_clear()
    assert styles.ms(trace, "pixels") == pytest.approx(1e3 * 1e-9 * (30 + 40
                                                                    + 50))
    assert styles.ms(trace, "encode") == pytest.approx(1e3 * 1e-9 * (20 + 60))
    assert styles.ops("pixels") == 3 and styles.ops("encode") == 2
    old = [p for p in paths if not p[-1].endswith((".encode", ".pixels"))]
    monkeypatch.setattr(stages, "live_map", lambda: (old, names[:len(old)]))
    styles.per_call.cache_clear()
    assert styles.ms(trace, "pixels") is None and styles.ops("pixels") is None
    styles.per_call.cache_clear()


def test_config_holds_the_spec_as_one_string():
    """The configuration's agent list is one JSON string (``cli_flags``
    passes ``str(v)``), the perf gate's population."""
    conf = json.loads((ROOT / "portbench/configs/goal_cycle_mixed_styles.json")
                      .read_text())
    spec = json.loads(conf["args"]["agent_config"])
    assert [a.get("observation_style", "encode") for a in spec] == [
        "encode", "image", "encode", "image"]

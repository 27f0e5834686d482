#!/usr/bin/env python3
"""Two trees of the port compared on one card, in one call: the kernels
of the recurrent paths' embed backward and the device time of their train
steps, for the tree at ROOT.

    python3 chip_pair.py ROOT LABEL

Run it once per tree and in turns, from the root of a checkout, with the
other tree unpacked by ``git archive`` into a git-ignored directory::

    for t in old . . old; do python3 chip_pair.py $t $t; done

Each run builds ROOT's kernels, times K5b (``onehot_embed2_bwd``) at the
hetero recurrent groups' update shapes (R = 1024, S = 128, H = 128, the
full vocabulary, 49 and 25 view cells; codes across and beyond the
vocabulary, a random bf16 dout), then profiles one recurrent-encode train
step and one hetero recurrent train step (views 7/5/7/5) after two
unprofiled steps each, with ROOT's ``chip_smoke.py`` phases, and prints
the numbers as one JSON line starting with ``[pair]``. Needs one CUDA
card; imports nothing of JAX.

It drives ROOT's own ``chip_smoke.py`` through these of its functions, and
so pairs only trees whose ``chip_smoke.py`` has them with these signatures
and results: ``card_line()``, ``phase_build()``, ``_codes(R, cells, S,
gen)``, ``time_ms(fn, iters=)`` -> (device ms, host ms), ``phase_rnn(seed,
card, steps=)`` and ``phase_hetero(seed, card, "hetero-rnn", steps=)`` ->
dicts with ``step`` (the eager step: ``jit=False`` in trees that graph the
train step), ``env``, ``h`` and ``key``, and ``profile_stages(run,
prefixes, card, title)`` -> a dict with ``wall_s``, ``device_busy_s``,
``device_ops`` and ``stages[name]["device_ms"]``; and ROOT's
``ops.embed.WIDTHS`` and ``ops.embed2.onehot_embed2_bwd(x, dout, widths,
values)``. The oldest tree it has been run against is commit 73e53de (the
embed forwards on the tensor cores); a change to any of these functions
has to keep that tree pairable, or say which trees it drops here.
"""
import json
import os
import sys

root, label = sys.argv[1], sys.argv[2]
os.chdir(root)
sys.path.insert(0, os.path.abspath("."))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from marlgrid_tpu_torch.ops import embed as E  # noqa: E402
from marlgrid_tpu_torch.ops import embed2 as E2  # noqa: E402

card = cs.card_line()
cs.phase_build()
out = {"label": label, "root": root, "card": card}
gen = torch.Generator().manual_seed(9)
for cells in (49, 25):
    x = cs._codes(1024, cells, 128, gen)
    dout = (torch.randn(1024, 128, 128, generator=gen) * 1e-3).to(
        torch.bfloat16).cuda()
    ms, _ = cs.time_ms(lambda: E2.onehot_embed2_bwd(x, dout, E.WIDTHS, None),
                       iters=20)
    out[f"k5b_ms_{cells}"] = ms
    print(f"[pair {label}] K5b R=1024 cells={cells} full vocabulary: "
          f"{ms * 1e3:.2f} us [{card}]", flush=True)
rnn = cs.phase_rnn(0, card, steps=2)
p = cs.profile_stages(lambda: rnn["step"](rnn["env"], rnn["h"], rnn["key"]),
                      ("rollout.", "update."), card,
                      f"{label}: one recurrent train step")
out["rnn"] = {k: p[k] for k in ("wall_s", "device_busy_s", "device_ops")}
out["rnn"]["backward_ms"] = p["stages"]["update.backward"]["device_ms"]
del rnn
hr = cs.phase_hetero(0, card, "hetero-rnn", steps=2)
p = cs.profile_stages(lambda: hr["step"](hr["env"], hr["h"], hr["key"]),
                      ("rollout.", "update."), card,
                      f"{label}: one hetero recurrent train step")
out["hetero_rnn"] = {k: p[k] for k in ("wall_s", "device_busy_s",
                                       "device_ops")}
out["hetero_rnn"]["backward_ms"] = p["stages"]["update.backward"]["device_ms"]
print("[pair] " + json.dumps(out), flush=True)

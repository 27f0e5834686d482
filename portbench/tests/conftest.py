"""The benchmark's tests: on the CPU they check the manifest, the frozen
arithmetic and a tiny rehearsal of every cell; the tests marked ``card``
run the checks of the checks at the cells' own sizes and skip without a
CUDA card (run them on the card with ``python3 -m pytest -q -m card
portbench/tests``)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def round_once_on_cpu():
    """The port's embed on the CPU rounded as the card's kernel (K2f)
    rounds it: the float32 sum of the planes' products, rounded once. (The
    port's plain version rounds each plane's product to bf16; the
    reference, like K2f, rounds once.) One CPU thread, so that the
    program's and the reference's reductions sum in one order. Returns
    what undoes both."""
    import torch
    from marlgrid_tpu_torch.ops import embed

    real = embed._forward

    def once(x, w, widths, values, dtype):
        if x.device.type != "cpu":
            return real(x, w, widths, values, dtype)
        return embed.onehot_embed_plain(x, w.to(dtype).float(), widths,
                                        values, torch.float32).to(dtype)

    embed._forward = once
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def undo():
        embed._forward = real
        torch.set_num_threads(threads)
    return undo


@pytest.fixture
def cpu_as_card():
    undo = round_once_on_cpu()
    yield
    undo()


@pytest.fixture(scope="session")
def bench_path():
    return ROOT / "BENCHMARK.json"

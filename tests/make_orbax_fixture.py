"""Write the orbax fixtures that hosts without JAX read: CoAM variables
saved with buctd_tpu's ``save_params``, and the digest of every leaf.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py [NAME [OUT_DIR]]

NAME is one of FIXTURES (default: all of them):

* ``orbax_coam_tiny``: a narrow CoAM (4/8/16/32 channels, 64 x 32 crops),
  every value drawn from the seed;
* ``orbax_coam_w48``: CoAM-W48 at full width (115.7 M values, 463 MB of
  f32), each leaf a pattern of PERIOD seeded values repeated, which zstd
  keeps in under 2 MB while a reader still decodes every byte.

OUT_DIR (default ``tests/fixtures/<NAME>``) gets ``checkpoint/``, the orbax
directory, and ``expected.json``: the yaml and overrides the model was built
from, the seed, the period, and each leaf's path, dtype, shape and SHA-256.
It imports JAX and is not a test.  ``chip_smoke.py::orbax_phase`` reads both
committed copies on the card's host; tests/test_torch_port_orbax.py writes
fresh ones and holds both copies against ``expected.json``.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from buctd_tpu_torch.train.checkpoint import leaf_digests  # noqa: E402

FIXTURE = REPO / "tests" / "fixtures" / "orbax_coam_tiny"
FULL_FIXTURE = REPO / "tests" / "fixtures" / "orbax_coam_w48"
YAML = "experiments/crowdpose/buctd/coam_w48_384x288.yaml"
# tests/test_torch_port_config.py's TINY_COAM, narrowed to 4/8/16/32 channels
# and 64 x 32 crops so that the directory stays under 2 MB, with the flash
# engine, so that serving the fixture on the card launches K1
OPTS = ["MODEL.IMAGE_SIZE", "[32, 64]", "MODEL.HEATMAP_SIZE", "[8, 16]",
        "MODEL.EXTRA.STAGE2.NUM_MODULES", "1", "MODEL.EXTRA.STAGE3.NUM_MODULES", "1",
        "MODEL.EXTRA.STAGE4.NUM_MODULES", "1",
        "MODEL.EXTRA.STAGE2.NUM_CHANNELS", "[4, 8]",
        "MODEL.EXTRA.STAGE3.NUM_CHANNELS", "[4, 8, 16]",
        "MODEL.EXTRA.STAGE4.NUM_CHANNELS", "[4, 8, 16, 32]",
        "MODEL.EXTRA.STAGE2.NUM_BLOCKS", "[1, 1]",
        "MODEL.EXTRA.STAGE3.NUM_BLOCKS", "[1, 1, 1]",
        "MODEL.EXTRA.STAGE4.NUM_BLOCKS", "[1, 1, 1, 1]",
        "TEST.POST_PROCESS", "True", "TPU.ATTENTION_ENGINE", "flash"]
SEED = 0
# the full-width fixture's leaves repeat this many values (a prime, so that
# the pattern runs across channels rather than down one)
PERIOD = 61
# name -> (opts, seed, period)
FIXTURES = {"orbax_coam_tiny": (OPTS, SEED, None), "orbax_coam_w48": ([], 48, PERIOD)}


def seeded_variables(cfg, seed: int, period: int | None = None):
    """The JAX model of ``cfg`` and its variable tree, shaped by
    ``jax.eval_shape(model.init)`` and filled from
    ``np.random.default_rng(seed)``: kernels N(0, 1/fan_in), scales and
    variances U(0.5, 1.5), biases and means N(0, 0.01).  With ``period``,
    each leaf draws that many values and repeats them to its size."""
    import jax
    import jax.numpy as jnp

    from buctd_tpu.data.pipeline import num_input_channels
    from buctd_tpu.models import get_model

    model = get_model(cfg)
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    x = jnp.zeros((1, img_h, img_w, num_input_channels(cfg)))
    shapes = jax.eval_shape(lambda k: model.init(k, x, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape if period is None else (min(period, int(np.prod(leaf.shape))),)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        return np.resize(x.astype(np.float32), leaf.shape)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def write_fixture(out: Path = FIXTURE, name: str = "orbax_coam_tiny") -> dict:
    """Writes fixture ``name``'s ``out/checkpoint`` and ``out/expected.json``;
    returns the latter."""
    import types

    from buctd_tpu.config import default_config, update_config
    from buctd_tpu.train.checkpoint import save_params

    opts, seed, period = FIXTURES[name]
    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(REPO / YAML), opts=list(opts)))
    _, variables = seeded_variables(cfg, seed, period)
    out = Path(out)
    shutil.rmtree(out / "checkpoint", ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    save_params(variables, str(out / "checkpoint"))
    expected = {"cfg": YAML, "opts": opts, "seed": seed, "period": period,
                "leaves": leaf_digests(variables)}
    (out / "expected.json").write_text(json.dumps(expected, indent=0, sort_keys=True) + "\n")
    return expected


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    names = sys.argv[1:2] or list(FIXTURES)
    for fixture in names:
        target = Path(sys.argv[2]) if len(sys.argv) > 2 else REPO / "tests" / "fixtures" / fixture
        exp = write_fixture(target, fixture)
        size = sum(p.stat().st_size for p in (target / "checkpoint").rglob("*") if p.is_file())
        print(f"{fixture}: {len(exp['leaves'])} leaves, {size} bytes in {target / 'checkpoint'}")

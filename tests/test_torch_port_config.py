"""buctd_tpu_torch: config parity, import isolation, and the helpers the other
port tests share (tiny CoAM configs, JAX weights carried across)."""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
COAM_YAML = REPO / "experiments" / "crowdpose" / "buctd" / "coam_w48_384x288.yaml"

# the TINY overrides of tests/test_refine.py, narrowed: one module and one block
# per stage, 8/16/32/64 channels; ATT_MODULES stays [F, T, F, F] from the yaml
TINY_COAM = ["MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
             "MODEL.EXTRA.STAGE2.NUM_MODULES", "1",
             "MODEL.EXTRA.STAGE3.NUM_MODULES", "1",
             "MODEL.EXTRA.STAGE4.NUM_MODULES", "1",
             "MODEL.EXTRA.STAGE2.NUM_CHANNELS", "[8, 16]",
             "MODEL.EXTRA.STAGE3.NUM_CHANNELS", "[8, 16, 32]",
             "MODEL.EXTRA.STAGE4.NUM_CHANNELS", "[8, 16, 32, 64]",
             "MODEL.EXTRA.STAGE2.NUM_BLOCKS", "[1, 1]",
             "MODEL.EXTRA.STAGE3.NUM_BLOCKS", "[1, 1, 1]",
             "MODEL.EXTRA.STAGE4.NUM_BLOCKS", "[1, 1, 1, 1]",
             "TEST.POST_PROCESS", "True"]

TRANSPOSE_YAML = REPO / "experiments" / "coco" / "buctd" / "transpose_h_384x288.yaml"
# the yaml narrowed: 8/16/32 channels, one block a branch, stage 3 with two
# modules (a multi-scale one, then the single-scale last), d_model 16 (+ 16
# condition channels: d = 32), 2 encoder layers; 128x96 images give 32x24 =
# 768 tokens, over the flash path's 512^2 threshold
TINY_TRANSPOSE = ["MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
                  "MODEL.EXTRA.STAGE2.NUM_CHANNELS", "[8, 16]",
                  "MODEL.EXTRA.STAGE3.NUM_CHANNELS", "[8, 16, 32]",
                  "MODEL.EXTRA.STAGE2.NUM_BLOCKS", "[1, 1]",
                  "MODEL.EXTRA.STAGE3.NUM_BLOCKS", "[1, 1, 1]",
                  "MODEL.EXTRA.STAGE3.NUM_MODULES", "2",
                  "MODEL.DIM_MODEL", "16", "MODEL.DIM_FEEDFORWARD", "32",
                  "MODEL.ENCODER_LAYERS", "2"]


def load_cfg(package: str, yaml=COAM_YAML, opts=()):
    """The same YAML + overrides through buctd_tpu or buctd_tpu_torch's config."""
    if package == "jax":
        from buctd_tpu.config import default_config, update_config
    else:
        from buctd_tpu_torch.config import default_config, update_config
    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(yaml), opts=list(opts)))
    return cfg


def jax_variables(cfg, seed: int = 0, channels: int = 6):
    """JAX model + variables for ``cfg`` (``channels`` input channels), every
    leaf drawn from a numpy seed.

    The shapes come from ``jax.eval_shape`` (no init compile).  Weights are
    N(0, 1/fan_in) and the BN statistics non-trivial, so the heatmaps are O(1)
    and have clear peaks: the reference's N(0, 0.001) init gives near-flat
    maps whose argmax a 1e-7 difference can flip."""
    import jax
    import jax.numpy as jnp

    from buctd_tpu.models import get_model

    model = get_model(cfg)
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, img_h, img_w, channels)),
                                                 train=False), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)   # bias, mean

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(cfg, variables):
    """buctd_tpu_torch model for ``cfg`` carrying the JAX ``variables``."""
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.models import get_model

    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_flax(variables), strict=True)
    return model


# ---------------------------------------------------------------- tests ----

def _flatten(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_default_config_matches_jax_key_for_key():
    from buctd_tpu.config import default_config as jax_default
    from buctd_tpu_torch.config import default_config

    assert _flatten(default_config()) == _flatten(jax_default())


@pytest.mark.parametrize("yaml", sorted((REPO / "experiments").rglob("*.yaml")),
                         ids=lambda p: str(p.relative_to(REPO / "experiments")))
def test_every_experiment_yaml_loads_in_both_packages(yaml):
    from buctd_tpu.data.pipeline import condition_mode as jax_mode
    from buctd_tpu.data.pipeline import num_input_channels as jax_channels
    from buctd_tpu_torch.data.pipeline import condition_mode, num_input_channels

    cfg, jcfg = load_cfg("torch", yaml), load_cfg("jax", yaml)
    assert _flatten(cfg) == _flatten(jcfg)
    assert condition_mode(cfg) == jax_mode(jcfg)
    assert num_input_channels(cfg) == jax_channels(jcfg)


def launcher_command(script: Path) -> tuple:
    """The yaml and ``KEY VALUE`` overrides of a stock launcher's ``python
    tools/X.py --cfg <yaml> ...`` command (line continuations, quotes and
    comments as bash reads them)."""
    import shlex

    text = script.read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.strip().startswith("python tools/"))
    words = shlex.split(line, comments=True)
    at = words.index("--cfg")
    assert at == 2 and len(words[at + 2:]) % 2 == 0, words
    return REPO / words[at + 1], words[at + 2:]


LAUNCHERS = sorted((REPO / "scripts").glob("t*/*.sh"))


@pytest.mark.parametrize("script", LAUNCHERS, ids=lambda p: str(p.relative_to(REPO / "scripts")))
def test_stock_launcher_overrides_load_in_both_packages(script):
    """The published protocols (scripts/test/*.sh, scripts/train/*.sh) with
    their overrides, which a user runs through valid.run / train.run: the
    same flattened config, condition mode and input channels in both."""
    from buctd_tpu.data.pipeline import condition_mode as jax_mode
    from buctd_tpu.data.pipeline import num_input_channels as jax_channels
    from buctd_tpu_torch.data.pipeline import condition_mode, num_input_channels

    yaml, opts = launcher_command(script)
    assert yaml.is_file() and opts, (yaml, opts)
    cfg, jcfg = load_cfg("torch", yaml, opts), load_cfg("jax", yaml, opts)
    assert _flatten(cfg) == _flatten(jcfg)
    assert condition_mode(cfg) == jax_mode(jcfg)
    assert num_input_channels(cfg) == jax_channels(jcfg)


def test_launchers_parsed_whole():
    """All seven launchers are found, and the parser reads every override of
    one with comments after its command."""
    assert len(LAUNCHERS) == 7
    yaml, opts = launcher_command(REPO / "scripts" / "train" / "train_BUCTD_COAM_tpu_native.sh")
    assert yaml == REPO / "experiments" / "coco" / "buctd" / "coam_w48_384x288.yaml"
    assert opts[-2:] == ["TPU.COMPUTE_DTYPE", "bfloat16"] and len(opts) == 30


def test_import_leaves_jax_out():
    """In a fresh interpreter, importing every module of the port pulls in
    none of jax, flax, buctd_tpu, orbax, tensorstore, zstandard and numcodecs
    (the pytest process already holds JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import buctd_tpu_torch\n"
        "mods = [importlib.import_module(m.name) for m in pkgutil.walk_packages(\n"
        "    buctd_tpu_torch.__path__, 'buctd_tpu_torch.')]\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'flax', 'buctd_tpu', 'orbax', 'tensorstore', 'zstandard',\n"
        "              'numcodecs'))\n"
        "print(bad, len(mods))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[-1]) >= 15   # the walk really saw the package


def test_source_imports_no_jax():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|buctd_tpu|orbax|tensorstore|zstandard|"
                     r"numcodecs)(\.|\s|$)", re.M)
    files = sorted((REPO / "buctd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        assert not pat.search(f.read_text()), (f"{f} imports jax/flax/buctd_tpu/orbax/"
                                               "tensorstore/zstandard/numcodecs")


def test_rainbow_colors_match_jax_without_matplotlib():
    from buctd_tpu.data.joints_dataset import rainbow_colors as jax_colors
    from buctd_tpu_torch.data.joints_dataset import rainbow_colors

    for n in (1, 3, 14, 17, 21):
        np.testing.assert_array_equal(rainbow_colors(n), jax_colors(n))

"""buctd_tpu_torch/tools/parity_eval.py vs the repository's tools/parity_eval.py.

Both runners take the same .pth (``from_flax`` of JAX variables drawn from a
numpy seed, under ``latest_state_dict``), the tiny CoAM of
test_torch_port_config.TINY_COAM and a synthetic CrowdPose-format set of 2
images x 2 people, at TEST batch 3 and one loader worker, for 2 refinement
rounds.  JAX's runner is loaded in-process from tools/ (``BUCTD_FORCE_CPU``,
as tests/test_cli.py runs it; its stdout captured); nothing of it is edited.

Tolerances, entry by entry of each round's results json:
* ``image_id`` and ``annotation_id`` equal;
* keypoints within KP_ATOL px (measured: 3.1e-5 px in round 0, 6.1e-5 in
  round 1; f32 sums in another order);
* confidences and scores within CONF_RTOL[0] in round 0 (measured 1.4e-6);
  from round 1 on within CONF_RTOL[1]: round 1's boxes come from round 0's
  keypoints, which moved by ~1e-5 px, and the host cv2 crops round to uint8,
  so a few crop pixels differ by one level (4.3e-4 here; an earlier run of
  this comparison with other weights measured up to 6.1e-3 on values of
  0.04-16.8);
* AP within AP_ATOL on the 0-100 scale; ``expected``, ``pass`` and the exit
  codes equal.  AP is 0 at random weights, so the results jsons are the check
  that has teeth.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_data_pipeline import _tiny_coco
from test_torch_port_config import COAM_YAML, REPO, TINY_COAM, jax_variables, load_cfg

J = 14
ROUNDS = 2
KP_ATOL = 1e-3
CONF_RTOL = (1e-5, 2e-3)
AP_ATOL = 0.1
OPTS = TINY_COAM + ["TEST.BATCH_SIZE_PER_GPU", "3", "WORKERS", "1"]
PRENET_YAML = REPO / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
ORBAX_TINY = REPO / "tests" / "fixtures" / "orbax_coam_tiny"
RESULTS = "results/keypoints_test_results_epoch{}.json"
KEYS = ("ap", "expected", "delta", "pass", "refine_trajectory")


def _pth(path, cfg, seed, extra=None):
    """A BUCTD .pth of JAX variables for ``cfg`` (numpy seed), with
    ``extra`` keys added or, where a value is None, taken out."""
    from buctd_tpu_torch.convert import from_flax

    _, variables = jax_variables(cfg, seed=seed)
    sd = from_flax(variables)
    for k, v in (extra or {}).items():
        if v is None:
            del sd[k]
        else:
            sd[k] = v
    torch.save({"latest_state_dict": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    ann, _ = _tiny_coco(root, n_imgs=2, people=2, J=J)
    opts = OPTS + ["LOG_DIR", str(root / "log")]
    pth = _pth(root / "tiny.pth", load_cfg("jax", opts=opts), seed=21)
    return {"root": root, "ann": ann, "pth": pth, "opts": opts}


def _argv(data, out, yaml=COAM_YAML, pth=None, rounds=ROUNDS, opts=None, flags=()):
    return ["--cfg", str(yaml), "--pth", pth or data["pth"], "--ann", data["ann"],
            "--img-dir", str(data["root"]), "--refine-iters", str(rounds),
            "--out", str(data["root"] / out), *flags,
            *(data["opts"] if opts is None else opts)]


def port(argv):
    """The port's runner on the CPU: (verdict, exit code, stdout)."""
    from buctd_tpu_torch.tools import parity_eval

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        verdict, rc = parity_eval.main(["--device", "cpu", *argv])
    return verdict, rc, out.getvalue()


@pytest.fixture(scope="module")
def jax_runner():
    """tools/parity_eval.py, imported as tools/_init_paths.py expects (tools/
    on sys.path; BUCTD_FORCE_CPU keeps JAX on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BUCTD_FORCE_CPU", "1")
        mp.syspath_prepend(str(REPO / "tools"))
        spec = importlib.util.spec_from_file_location("jax_parity_eval",
                                                      REPO / "tools" / "parity_eval.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        def run(argv, template_shapes_only=False):
            """(exit code, stdout) of its main under ``argv``.  With
            ``template_shapes_only`` its ``jax.jit`` of the model's init (the
            converter's template, ~20 s to compile on the CPU) gives zeros of
            the init's shapes from ``jax.eval_shape``: for a run that stops at
            the checkpoint's conversion, which reads the template's tree,
            shapes and dtypes only."""
            import jax
            import jax.numpy as jnp

            def shapes_of(fn, *a, **k):
                return lambda *args: jax.tree_util.tree_map(
                    lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(fn, *args))

            with pytest.MonkeyPatch.context() as call:
                call.setattr(sys, "argv", ["parity_eval.py", *argv])
                if template_shapes_only:
                    call.setattr(jax, "jit", shapes_of)
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = mod.main()
            return rc, out.getvalue()

        run.module = mod
        yield run


@pytest.fixture(scope="module")
def both(data, jax_runner):
    verdict, rc, stdout = port(_argv(data, "ours"))
    jrc, jstdout = jax_runner(_argv(data, "jax"))
    return {"port": (verdict, rc, stdout), "jax": (jrc, jstdout)}


def _results(root, it):
    return json.loads((root / "crowdpose" / "pose_hrnet_coam" / "coam_w48_384x288"
                       / RESULTS.format(it)).read_text())


def test_results_match_jax_round_by_round(data, both):
    verdict = both["port"][0]
    assert [r["results"] for r in verdict["run"]["rounds"]] == [
        str(verdict["run"]["output_dir"] / RESULTS.format(it)) for it in range(ROUNDS)]
    for it in range(ROUNDS):
        got, want = _results(data["root"] / "ours", it), _results(data["root"] / "jax", it)
        assert len(got) == len(want) == 4
        rtol = CONF_RTOL[min(it, 1)]
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert (g["image_id"], g.get("annotation_id")) == (w["image_id"],
                                                              w.get("annotation_id"))
            kg, kw = np.reshape(g["keypoints"], (J, 3)), np.reshape(w["keypoints"], (J, 3))
            np.testing.assert_allclose(kg[:, :2], kw[:, :2], atol=KP_ATOL, rtol=0)
            np.testing.assert_allclose(kg[:, 2], kw[:, 2], rtol=rtol)
            np.testing.assert_allclose(g["score"], w["score"], rtol=rtol)
    # round 1 ran from round 0's keypoints: its boxes moved
    assert _results(data["root"] / "ours", 1)[0]["keypoints"] != \
        _results(data["root"] / "ours", 0)[0]["keypoints"]


def test_table_trajectory_and_verdict_match_jax(both):
    verdict, rc, stdout = both["port"]
    jrc, jstdout = both["jax"]
    assert rc == jrc == 1 and verdict["verdict"] == "FAIL"
    lines, jlines = stdout.strip().splitlines(), jstdout.strip().splitlines()
    # the trajectory, a blank line, the header, the rule, the row, the target, the JSON
    assert len(lines) == len(jlines) == 7
    assert lines[0].startswith("# refine trajectory: AP ") and lines[0].count("->") == 1
    assert lines[2:4] == jlines[2:4] == [
        "| dataset | model | ours (AP) | reference (AP) | delta | verdict |",
        "|---|---|---|---|---|---|"]
    row, jrow = lines[4].split(" | "), jlines[4].split(" | ")
    assert row[:2] == jrow[:2] == ["| crowdpose", "pose_hrnet_coam"]
    assert row[3] == jrow[3] == "78.5" and row[5] == jrow[5] == "FAIL |"
    assert abs(float(row[2]) - float(jrow[2])) <= AP_ATOL
    assert lines[5] == jlines[5] and lines[5].startswith("# target: BUCTD-CoAM-W48")
    got, want = json.loads(lines[-1]), json.loads(jlines[-1])
    assert set(got) == set(want) == set(KEYS)
    assert {k: verdict[k] for k in KEYS} == got
    assert (got["expected"], got["pass"]) == (want["expected"], want["pass"]) == (78.5, False)
    assert abs(got["ap"] - want["ap"]) <= AP_ATOL
    assert abs(got["delta"] - want["delta"]) <= AP_ATOL
    assert len(got["refine_trajectory"]) == len(want["refine_trajectory"]) == ROUNDS
    np.testing.assert_allclose(got["refine_trajectory"], want["refine_trajectory"],
                               atol=AP_ATOL, rtol=0)
    assert got["ap"] == got["refine_trajectory"][-1]


def test_reference_table_is_jax_runners(jax_runner):
    from buctd_tpu_torch.tools import parity_eval

    assert parity_eval.REFERENCE_AP == jax_runner.module.REFERENCE_AP
    assert parity_eval.AP_TOLERANCE == jax_runner.module.AP_TOLERANCE


@pytest.fixture(scope="module")
def prenet(data):
    """The tiny preNet-W48 (crowdpose, no README row): its .pth and
    overrides."""
    opts = data["opts"] + ["MODEL.IMAGE_SIZE", "[64, 96]", "MODEL.HEATMAP_SIZE", "[16, 24]"]
    cfg = load_cfg("jax", PRENET_YAML, opts)
    assert cfg.MODEL.NAME == "pose_hrnet" and cfg.MODEL.EXTRA.USE_PRE_NET
    return {"opts": opts, "pth": _pth(data["root"] / "prenet.pth", cfg, seed=22)}


@pytest.mark.parametrize("case", ["readme_target", "zero_target", "near_target", "no_target"])
def test_verdicts(data, both, prenet, case):
    """One round through the port's main for each way the verdict falls."""
    ap0 = both["port"][0]["refine_trajectory"][0]     # this set's round 0, these weights
    argv = {"readme_target": [],
            "zero_target": ["--expected-ap", "0"],
            "near_target": ["--expected-ap", str(ap0 + 0.25)]}
    if case == "no_target":
        args = _argv(data, f"verdict_{case}", PRENET_YAML, prenet["pth"], 1, prenet["opts"])
    else:
        args = _argv(data, f"verdict_{case}", rounds=1, flags=argv[case])
    verdict, rc, stdout = port(args)
    lines = stdout.strip().splitlines()
    assert "# refine trajectory" not in stdout          # one round
    assert lines[0] == "| dataset | model | ours (AP) | reference (AP) | delta | verdict |"
    assert verdict["refine_trajectory"] == [verdict["ap"]]
    if case == "no_target":
        assert (rc, verdict["verdict"], verdict["pass"]) == (0, "NO-TARGET", None)
        assert lines[-2] == (f"| crowdpose | pose_hrnet | {verdict['ap']:.2f} | n/a | n/a "
                             f"| NO-TARGET |")
        assert lines[-1] == "# no README row for this dataset/model pair"
        return
    assert verdict["ap"] == ap0
    last = json.loads(lines[-1])
    assert last == {k: verdict[k] for k in KEYS}
    want = {"readme_target": (1, "FAIL", 78.5), "zero_target": (0, "PASS", 0.0),
            "near_target": (0, "PASS", ap0 + 0.25)}[case]
    assert (rc, verdict["verdict"], last["expected"]) == want
    assert last["pass"] == (rc == 0) and last["delta"] == last["ap"] - last["expected"]
    assert lines[-3].endswith(f"| {verdict['verdict']} |")
    note = "user-provided target" if case != "readme_target" else "BUCTD-CoAM-W48"
    assert lines[-2].startswith(f"# target: {note}")


def test_knobs_the_jax_runner_ignores_are_ignored(data, prenet, monkeypatch):
    """TPU.DEVICE_PIPELINE True, TPU.FUSED_PRENET auto and TEST.LAMBDA_SWEEP
    True change nothing: the host Loader, no fusion, plain validate (each of
    the others raises if reached), and the same results json each round."""
    import buctd_tpu_torch.core.function as function
    import buctd_tpu_torch.data.device_pipeline as device_pipeline
    import buctd_tpu_torch.models.fuse as fuse

    plain = port(_argv(data, "knobs_off", PRENET_YAML, prenet["pth"], opts=prenet["opts"]))[0]

    def refuse(name):
        def call(*a, **k):
            raise AssertionError(f"the parity runner reached {name}")
        return call

    monkeypatch.setattr(device_pipeline, "DeviceLoader", refuse("DeviceLoader"))
    monkeypatch.setattr(fuse, "maybe_fuse_prenet", refuse("maybe_fuse_prenet"))
    monkeypatch.setattr(function, "validate_lambda_quantitative",
                        refuse("validate_lambda_quantitative"))
    knobs = prenet["opts"] + ["TPU.DEVICE_PIPELINE", "True", "TPU.FUSED_PRENET", "auto",
                              "TEST.LAMBDA_SWEEP", "True"]
    got = port(_argv(data, "knobs_on", PRENET_YAML, prenet["pth"], opts=knobs))[0]
    assert not got["run"]["model"].fused_prenet
    assert len(got["run"]["rounds"]) == len(plain["run"]["rounds"]) == ROUNDS
    for r, p in zip(got["run"]["rounds"], plain["run"]["rounds"]):
        assert r["results"].endswith(".json") and "_merged" not in r["results"]
        assert json.loads(open(r["results"]).read()) == json.loads(open(p["results"]).read())


@pytest.mark.parametrize("edit", ["unused_lambda_head", "missing_key"])
def test_checkpoint_refused_as_by_jax(data, jax_runner, edit):
    """A checkpoint with keys the model lacks (pose_hrnet's lambda head, which
    the runner never builds) or without one it has is refused: the port's
    strict load raises RuntimeError, JAX's strict torch_to_flax KeyError."""
    cfg = load_cfg("jax", opts=data["opts"])
    extra = ({"lambda_fc.weight": torch.zeros(2, 4), "lambda_fc.bias": torch.zeros(2)}
             if edit == "unused_lambda_head" else {"final_layer.bias": None})
    pth = _pth(data["root"] / f"{edit}.pth", cfg, seed=21, extra=extra)
    key = "lambda_fc" if edit == "unused_lambda_head" else "final_layer.bias"
    with pytest.raises(RuntimeError, match=key):
        port(_argv(data, f"refused_{edit}", pth=pth, rounds=1))
    with pytest.raises(KeyError, match=key):
        jax_runner(_argv(data, f"refused_jax_{edit}", pth=pth, rounds=1),
                   template_shapes_only=True)


def test_orbax_directory_from_the_command_line(data):
    """python -m buctd_tpu_torch.tools.parity_eval --device cpu with the
    committed orbax fixture as --pth: the table, a last line of JSON, and
    the same results json as an in-process run from a .pth of the same
    state_dict."""
    from buctd_tpu_torch.convert import load_orbax_checkpoint

    expected = json.loads((ORBAX_TINY / "expected.json").read_text())
    yaml, opts = REPO / expected["cfg"], expected["opts"] + [
        "TEST.BATCH_SIZE_PER_GPU", "3", "WORKERS", "1", "LOG_DIR", str(data["root"] / "log")]
    pth = data["root"] / "orbax_tiny.pth"
    torch.save(load_orbax_checkpoint(ORBAX_TINY / "checkpoint"), pth)
    verdict = port(_argv(data, "orbax_pth", yaml, str(pth), 1, opts))[0]
    # one torch thread, as this process (torch_cpu_threads): the same sums
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "buctd_tpu_torch.tools.parity_eval",
                          "--device", "cpu",
                          *_argv(data, "orbax_dir", yaml, str(ORBAX_TINY / "checkpoint"), 1,
                                 opts)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 1, res.stderr[-3000:]
    assert "| dataset | model | ours (AP) | reference (AP) | delta | verdict |" in res.stdout
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(last) == set(KEYS) and last["pass"] is False and last["expected"] == 78.5
    assert last["ap"] == verdict["ap"]
    assert _results(data["root"] / "orbax_dir", 0) == _results(data["root"] / "orbax_pth", 0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="refuses --device cuda only "
                                                      "where CUDA is absent")
def test_cuda_device_raises_without_cuda(data):
    from buctd_tpu_torch.tools import parity_eval

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity_eval.main(_argv(data, "cuda"))
    assert parity_eval.parse_args(_argv(data, "cuda")).device == "cuda"

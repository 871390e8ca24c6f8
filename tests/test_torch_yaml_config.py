"""The port's yaml reader (``utils/yaml_lite.py``) and ``config.load_config``
against PyYAML and the JAX package's ``load_config``, on the CPU.

- Every file under the JAX package's ``config/yaml/`` reads to PyYAML's
  ``safe_load`` dict, and the port's copy under its own ``config/yaml/`` is
  the same document but for the ``_target_`` names, which name the port's
  classes (``training.workspace.Trainer`` for ``TrainWorkspace``).
- The reader against PyYAML on the YAML it reads (flow collections, quoted
  strings and their escapes, comments, the YAML 1.1 scalars: null, the
  booleans, ints in four bases, floats with and without a dot), and a
  ValueError on what it does not read.
- ``load_config`` of all nine top-level yamls, with no overrides, with a
  group override and with dotted overrides, equals JAX's but for the
  ``_target_`` names. ``config.HUMAN_PP`` is JAX's ``load_config(
  "uva_human_pp")`` with ``HUMAN_PP_OVERRIDES``, field by field.
- The port's config imports no PyYAML (a fresh interpreter).
"""

import glob
import os
import subprocess
import sys

import pytest
import yaml

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from tests._torch_parity import leaves
from unified_video_action_tpu.config import load_config as jax_load_config
from unified_video_action_tpu_torch import config
from unified_video_action_tpu_torch.utils import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_YAML = os.path.join(REPO, "unified_video_action_tpu", "config", "yaml")
PORT_YAML = os.path.join(REPO, "unified_video_action_tpu_torch", "config", "yaml")
FILES = sorted(os.path.relpath(p, JAX_YAML)
               for p in glob.glob(os.path.join(JAX_YAML, "**", "*.yaml"), recursive=True))
TOP_LEVEL = sorted(os.path.splitext(f)[0] for f in FILES if os.sep not in f)


def port_targets(node):
    """JAX's document with each ``_target_`` naming the port's class."""
    if isinstance(node, dict):
        out = {k: port_targets(v) for k, v in node.items()}
        if isinstance(out.get("_target_"), str):
            target = out["_target_"].replace("unified_video_action_tpu.",
                                             "unified_video_action_tpu_torch.", 1)
            out["_target_"] = target.replace("workspace.TrainWorkspace", "workspace.Trainer")
        return out
    if isinstance(node, list):
        return [port_targets(v) for v in node]
    return node


def test_the_files_and_the_top_level_configs():
    assert len(FILES) == 19 and len(TOP_LEVEL) == 9
    assert FILES == sorted(os.path.relpath(p, PORT_YAML) for p in glob.glob(
        os.path.join(PORT_YAML, "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("name", FILES)
def test_every_yaml_reads_as_pyyaml(name):
    path = os.path.join(JAX_YAML, name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yaml_lite.load(path) == want
    ported = yaml_lite.load(os.path.join(PORT_YAML, name))
    with open(os.path.join(PORT_YAML, name)) as f:
        assert yaml.safe_load(f) == ported
    assert ported == port_targets(want)


CASES = [
    "a: 1\nb: [1, 2, {c: d, e: [f, 'g h']}]\n",
    "x: 1e-4\ny: 1.0e-4\nz: .5\nw: -3\nv: +4\nu: 012\nt: 0x1F\ns: -0b101\nr: 1_000\n",
    "a: 'it''s'\nb: \"q\\\"x\\n\\t\\u00e9\"\nc: \"a # not a comment\"\n",
    "- a\n- b: 1\n  c: 2\n- [1, 2]\n- {k: v}\n-\n",
    "a:\n- 1\n- 2\nb: {}\nc: []\nd:\n  - x\n  - y: z\n",
    "k: yes\nl: Off\nm: ~\nn:\no: .inf\np: -.Inf\nq: NULL\nr: True\ns: .NaN\n",
    "a: x # comment\nb: x#y\n# a whole line\nc:   # nothing\n  d: 3\n",
    "a: {b: null, c: , d: 'e'}\n",
    "'quoted key': 1\n\"other\": [\"x\", 'y']\nnum: 3.\n",
    "deep:\n  a:\n    b:\n      c: [1.5, -2.25e+3, hello world]\n",
    "",
    "# only a comment\n",
]


@pytest.mark.parametrize("text", CASES)
def test_the_reader_against_pyyaml(text):
    want = yaml.safe_load(text)
    got = yaml_lite.loads(text)
    if isinstance(want, dict) and "s" in want and want["s"] != want["s"]:  # NaN
        assert got["s"] != got["s"]
        want, got = ({k: v for k, v in d.items() if k != "s"} for d in (want, got))
    assert got == want


@pytest.mark.parametrize("text", ["a: b: c\n", "a: &x 1\n", "a: *x\n", "a: |\n  text\n",
                                  "a: [1, 2\n", "a: 'open\n", "a:\n\tb: 1\n", "f: [a, , b]\n"])
def test_the_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        yaml_lite.loads(text)


AMP = "model.policy.autoregressive_model_params."
OVERRIDES = {
    "none": [],
    "group": ["model=uva_small96", f"{AMP}img_size=64"],
    "dotted": [f"{AMP}model_size=mar_huge", "model.policy.action_model_params.predict_action=true",
               "training.num_epochs=2", "dataloader.batch_size=4"],
}


@pytest.mark.parametrize("overrides", sorted(OVERRIDES))
@pytest.mark.parametrize("name", TOP_LEVEL)
def test_load_config_is_jaxs(name, overrides):
    ov = OVERRIDES[overrides]
    want = port_targets(jax_load_config(name, ov).to_dict())
    assert config.load_config(name, ov) == want


def test_human_pp_is_load_config():
    want = port_targets(jax_load_config("uva_human_pp", list(config.HUMAN_PP_OVERRIDES)).to_dict())
    have = dict(leaves(config.HUMAN_PP))
    assert sorted(have) == sorted(dict(leaves(want)))
    for path, value in leaves(want):
        assert have[path] == value, path
    policy = config.HUMAN_PP["model"]["policy"]
    assert config.HUMAN_PP["task"]["name"] == "human_pp"
    assert policy["action_model_params"]["predict_action"] is True
    assert policy["shape_meta"]["action"]["shape"] == [14]
    assert config.HUMAN_PP["task"]["keypoints"]["eval"] is True
    assert config.HUMAN_PP["dataloader"]["batch_size"] == 32
    assert config.HUMAN_PP_TRAIN_OVERRIDES == config.SUITE_TRAIN_OVERRIDES


def test_the_port_config_imports_no_pyyaml():
    code = ("import sys; import unified_video_action_tpu_torch.config as c; "
            "c.load_config('uva_human_pp'); print('yaml' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr

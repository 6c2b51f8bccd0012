"""The port stands alone and runs on the card unless asked for the CPU.

* importing ``repro_torch`` (and its serving entry point) loads neither
  ``jax`` nor anything of ``repro``, and no source file imports them;
* with no CUDA device, the entry points raise instead of running on the
  CPU, and the kernel wrappers never launch (their counters stay 0) on CPU
  tensors: those take the plain versions.
"""
from __future__ import annotations

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                            flash_decode_cuda,
                                            paged_decode_cuda)
from repro_torch.kernels.rns_matmul import rns_matmul_cuda
from repro_torch.models.api import build_model
from repro_torch.numerics import api as nx
from repro_torch.numerics import attention as nxattn
from repro_torch.numerics import kv_pages as kvp
from repro_torch.serving.engine import ServingEngine

from torch_threads import one_thread  # noqa: F401

PKG_DIR = os.path.dirname(repro_torch.__file__)
SRC = os.path.dirname(PKG_DIR)


def _all_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="repro_torch."))


def test_import_leaves_jax_and_repro_unloaded():
    mods = _all_modules()
    assert "repro_torch.launch.serve" in mods
    # the dense-cache decode and the hybrid family are among them
    assert {"repro_torch.models.ssm", "repro_torch.configs.zamba2_7b",
            "repro_torch.models.transformer",
            "repro_torch.numerics.attention"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax_or_repro():
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)",
                     re.M)
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert offenders == []


def test_examples_import_neither_jax_nor_repro():
    """The port's examples stand alone: no import of ``jax`` or ``repro``
    in their source, and the quickstart run on the CPU loads neither."""
    root = os.path.dirname(SRC)
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)",
                     re.M)
    examples = [os.path.join(root, "examples", f) for f in (
        "torch_quickstart.py", "torch_rns_cnn_inference.py")]
    for path in examples:
        with open(path) as fh:
            assert not pat.search(fh.read()), path
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{examples[0]!r}, '--device', 'cpu']\n"
        f"runpy.run_path({examples[0]!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "A@B exact: True" in res.stdout
    assert "RnsTensor.matmul (lazy reduction, one centering): True" in \
        res.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")


def test_entry_points_raise_without_a_card(no_card):
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, system="rns")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, system="sdrns")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("zamba2-7b").reduced(), system="rns")
    model = build_model(cfg, system="rns", device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params, batch=1, s_max=8)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-8b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-7b", "--reduced"])


def test_cuda_wrappers_refuse_cpu_tensors():
    a = torch.zeros((3, 4, 16), dtype=torch.int8)
    b = torch.zeros((3, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        rns_matmul_cuda(a, b, (127, 128, 129))
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_cuda(torch.zeros((1, 2, 16)), q, q, None, None,
                          torch.zeros((1, 1), dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(torch.zeros((1, 2, 16)), q, q,
                          torch.ones(1, dtype=torch.int32), 8)


def test_launch_counters_stay_zero_on_cpu():
    kernels.reset_launch_counts()
    w = nx.encode(torch.randn(32, 16), nx.EncodeSpec(qbits=4))
    nx.matmul(torch.randint(-7, 8, (3, 32), dtype=torch.int32), w)
    q = torch.randn(1, 8, 4, 16)
    nxattn.flash_attention(q, q[:, :, :2], q[:, :, :2])
    pool = kvp.make_paged_kv(1, 3, 4, 2, 16, fmt="rns8", device="cpu")
    nxattn.paged_decode(torch.randn(2, 4, 16), kvp.layer_slice(pool, 0),
                        torch.tensor([[1], [2]], dtype=torch.int32),
                        torch.tensor([3, 4], dtype=torch.int32), page_size=4)
    pool = kvp.make_paged_kv(1, 3, 4, 2, 16, fmt="rns8r", device="cpu")
    nxattn.paged_decode(torch.randn(2, 4, 16), kvp.layer_slice(pool, 0),
                        torch.tensor([[1], [2]], dtype=torch.int32),
                        torch.tensor([3, 4], dtype=torch.int32), page_size=4,
                        syndrome=True)
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, system="rns", device="cpu")
    eng = ServingEngine(model, model.init(0), batch=2, s_max=12,
                        page_size=4, kv_format="rns8", device="cpu")
    res = eng.generate({"tokens": torch.randint(0, cfg.vocab, (2, 5))},
                       max_new=3)
    assert res.tokens.shape == (2, 3)
    model = build_model(cfg, system="sdrns", device="cpu")
    eng = ServingEngine(model, model.init(0), batch=2, s_max=12,
                        page_size=4, kv_format="rns8", device="cpu")
    res = eng.generate({"tokens": torch.randint(0, cfg.vocab, (2, 5))},
                       max_new=2)
    assert res.tokens.shape == (2, 2)
    sd = nx.encode(torch.randint(-7, 8, (8, 4)), nx.EncodeSpec(layout="sd"))
    nx.add(sd, sd)
    kd = torch.randn(2, 8, 2, 16)
    nxattn.flash_decode(torch.randn(2, 4, 16), kd, kd,
                        kv_len=torch.tensor([3, 8]))
    for arch in ("qwen3-8b", "zamba2-7b"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, system="rns", device="cpu")
        eng = ServingEngine(model, model.init(0), batch=2, s_max=12,
                            paged=False, device="cpu")
        res = eng.generate({"tokens": torch.randint(0, cfg.vocab, (2, 4))},
                           max_new=3)
        assert res.tokens.shape == (2, 3)
    assert kernels.launch_counts() == {"rns_matmul": 0, "flash_attention": 0,
                                       "paged_decode": 0,
                                       "paged_decode_syndrome": 0,
                                       "flash_decode": 0,
                                       "sdrns_matmul": 0, "sdrns_matvec": 0,
                                       "sd_add": 0, "rns_decode": 0}

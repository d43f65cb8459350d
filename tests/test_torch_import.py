"""The port stands apart from jax and from the JAX package: every module
imports with both blocked and no source (chip_smoke.py and
time_variants.py included) imports them, bench or tools; the zstd
stand-in writes files the real package reads and reads files it wrote;
the device rule raises instead of falling back; a kernel build without
nvcc fails loudly."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tomahawk_tpu_torch import device as D
from tomahawk_tpu_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "tomahawk_tpu_torch"


def _run(code, tmp_path):
    path = os.pathsep.join(filter(None, [str(REPO),
                                         os.environ.get("PYTHONPATH")]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240, cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_every_module_imports_without_jax(tmp_path):
    out = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tomahawk_tpu'] = None\n"
        "import importlib, pkgutil, tomahawk_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'tomahawk_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not [m for m, v in sys.modules.items()\n"
        "            if m.split('.')[0] in ('jax', 'tomahawk_tpu', 'bench',\n"
        "                                   'tools') and v is not None]\n"
        "print(len(names))\n", tmp_path)
    # every .py below the package but its own __init__ and __main__
    modules = [f for f in PKG.rglob("*.py") if "_compat" not in f.parts
               and f not in (PKG / "__init__.py", PKG / "__main__.py")]
    assert int(out.split()[-1]) == len(modules) == 54


def test_entry_points_import_without_the_jax_package(tmp_path):
    _run("import sys\n"
         "sys.modules['jax'] = None\n"
         "sys.modules['tomahawk_tpu'] = None\n"
         "import tomahawk_tpu_torch.cli, tomahawk_tpu_torch.compute.engine\n"
         "import tomahawk_tpu_torch.workloads\n"
         "import tomahawk_tpu_torch.parallel, tomahawk_tpu_torch.post.sort\n",
         tmp_path)


def test_no_source_names_jax():
    """No import of jax, the JAX package, bench or tools in any source of
    the port, in chip_smoke.py or in time_variants.py (relative imports
    stay inside the port)."""
    banned = {"jax", "tomahawk_tpu", "bench", "tools"}
    sources = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "time_variants.py"]
    assert len(sources) > 35
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] == ["from"]:
                names = words[1:2]
            elif words[:1] == ["import"]:
                names = [w for w in words[1:] if w != "as"]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {line}"


def test_zstd_stand_in_roundtrip(tmp_path):
    """Without the zstandard package the port binds libzstd: a .two it
    writes reads back through the real package, and it reads what the
    real package wrote."""
    from tomahawk_tpu.io.header import VcfContig, VcfHeader
    from tomahawk_tpu.io.two import TWO_DTYPE, TwoReader, TwoWriter
    hdr = VcfHeader(samples=["a", "b"], contigs=[VcfContig(idx=0, name="1")])
    recs = np.zeros(3000, TWO_DTYPE)
    recs["packA"] = np.arange(3000, dtype=np.uint32) << 2
    recs["R2"] = np.linspace(0, 1, 3000)
    real = str(tmp_path / "real.two")
    w = TwoWriter(real, hdr, block_limit=1000)
    w.add(recs)
    w.close()
    shim = str(tmp_path / "shim.two")
    _run("import importlib.machinery, sys\n"
         "class HideReal:\n"  # zstandard resolves only to the stand-in
         "    def find_spec(self, name, path=None, target=None):\n"
         "        if name != 'zstandard':\n"
         "            return None\n"
         "        compat = [p for p in sys.path if p.endswith('_compat')]\n"
         "        spec = importlib.machinery.PathFinder.find_spec(\n"
         "            name, compat)\n"
         "        if spec is None:\n"
         "            raise ModuleNotFoundError(name)\n"
         "        return spec\n"
         "sys.meta_path.insert(0, HideReal())\n"
         "import tomahawk_tpu_torch, zstandard\n"
         "assert zstandard.__file__.endswith('_compat/zstandard.py')\n"
         "from tomahawk_tpu.io.two import TwoReader, TwoWriter\n"
         f"r = TwoReader({real!r})\n"
         "recs = r.records()\n"
         "r.close()\n"
         f"w = TwoWriter({shim!r}, r.header, block_limit=700)\n"
         "w.add(recs)\n"
         "w.close()\n", tmp_path)
    r = TwoReader(shim)
    got = r.records()
    r.close()
    np.testing.assert_array_equal(got, recs)


def test_resolve_device(monkeypatch):
    assert D.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        D.resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        D.resolve_device("cuda")


def test_kernel_report_names_sources_and_tpu_code():
    rows = D.kernel_report()
    assert [r["name"] for r in rows] == ["phased_tile", "parts_tile",
                                         "compact", "local_parts",
                                         "tile_epilogue", "fisher_bracket"]
    for r in rows:
        assert (REPO / r["source"]).exists()
        path, line = r["replaces"].split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def "), text


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not _build.loaded()


def test_library_named_by_source_hash(tmp_path, monkeypatch):
    first = _build._lib_path()
    assert first.startswith(_build.BUILD_DIR)
    assert os.path.basename(first).startswith("libtwk_torch-")
    src = tmp_path / "csrc"
    src.mkdir()
    for name in _build.SOURCES + _build.HEADERS:
        text = (PKG / "csrc" / name).read_text()
        (src / name).write_text(text + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", str(src))
    assert _build._lib_path() != first

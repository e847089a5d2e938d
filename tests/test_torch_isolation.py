"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
``torch`` and ``numpy``, never ``jax`` and nothing of the reference
package ``repro`` (the machine with the card has no JAX)."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s+as\b)"
    r"|from\s+repro(\.|\s+import\b))", re.M)


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_import_pulls_in_no_jax_and_no_reference():
    names = _port_modules()
    for mod in ("kernels.paged_attention", "kernels.chunked_prefill",
                "kernels.decode_attention", "kernels.flash_attention",
                "kernels.ssd", "kernels.rglru", "models.ssm",
                "models.rglru", "models.model", "models.attention",
                "core.routing", "serving.engine", "serving.batcher",
                "serving.migration", "serving.sampling",
                "serving.session", "core.carbon", "core.audit",
                "core.tracegen", "core.workload", "launch.serve",
                "obs.trace", "obs.export", "obs.profile", "privacy",
                "privacy.adversary", "privacy.leakage", "data.pipeline",
                "training.optim", "checkpoint", "models.steps",
                "launch.train", "core.mist_model", "sharding",
                "launch.mesh", "launch.specs", "models.decode_sharded",
                "launch.dryrun", "launch.routed_serve"):
        assert f"repro_torch.{mod}" in names, mod
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]


def test_sources_name_no_jax_and_no_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        hit = FORBIDDEN.search(text)
        assert hit is None, f"{f.relative_to(ROOT)}: {hit.group(0).strip()}"


COPIES = ["data/tokenizer.py", "core/trust.py", "core/islands.py",
          "core/placeholder.py", "core/mist.py", "core/tide.py",
          "core/lighthouse.py", "core/waves.py", "core/tracegen.py",
          "core/workload.py", "serving/migration.py", "obs/metrics.py",
          "obs/trace.py", "obs/export.py", "core/carbon.py", "core/audit.py",
          "serving/session.py"]
COPIES.append("privacy/leakage.py")
COPIES.append("data/pipeline.py")


def test_copied_modules_match_the_reference():
    """The JAX-free modules the port copies are the reference's text with
    only their import paths changed (``serving/degrade.py`` also drops one
    docstring sentence and is left out here)."""
    files = COPIES + sorted(
        str(f.relative_to(SRC / "repro")) for f in
        (SRC / "repro" / "configs").glob("*.py"))
    for rel in files:
        ref = (SRC / "repro" / rel).read_text()
        want = re.sub(r"(^|\s)(from|import) repro\.", r"\1\2 repro_torch.",
                      ref).replace('import_module(f"repro.',
                                   'import_module(f"repro_torch.')
        assert (SRC / "repro_torch" / rel).read_text() == want, rel


def test_scan_catches_forbidden_imports():
    for bad in ("import jax", "from jax import numpy", "import repro.core",
                "from repro.kernels import ref", "from repro import x",
                "import repro", "    import jax.numpy as jnp"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import waves",
               "# jax is not imported here", "import jaxtyping_free_name"):
        assert not FORBIDDEN.search(ok), ok

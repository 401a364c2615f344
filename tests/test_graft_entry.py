"""The driver's entry points must work standalone, without conftest's env.

dryrun_multichip runs in a fresh process; on a CPU host __graft_entry__
must bootstrap its own virtual CPU mesh.  These tests run it in clean
subprocesses with conftest's env stripped.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_clean(code: str, extra_env=None, timeout=600):
    """Run `code` in a subprocess WITHOUT the virtual-device XLA_FLAGS."""
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    # Keep the subprocess on the CPU (the virtual-device path under test).
    env["JAX_PLATFORMS"] = "cpu"
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


@pytest.mark.slow  # ~1 min: full pixel-proof dryrun in a subprocess; the
# driver runs exactly this entry point every round, so the fast suite
# doesn't re-run it.
@pytest.mark.parametrize("n", [8])
def test_dryrun_multichip_standalone(n):
    """Fresh process, no XLA_FLAGS: must self-bootstrap an n-device mesh."""
    proc = _run_clean(
        f"import __graft_entry__ as g; g.dryrun_multichip({n})"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK" in proc.stdout


def test_entry_traces():
    """Fast rep for the driver entry points: entry() must import cleanly
    and its (fn, args) must trace (jax.eval_shape — no compile) to a
    frame-shaped result.  The full pixel-proof dryruns are -m slow (the
    driver also runs dryrun_multichip itself every round)."""
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.eval_shape(fn, *args)
    leaves = jax.tree.leaves(out)
    assert leaves, "entry() traced to an empty result"
    assert any(len(l.shape) >= 3 for l in leaves), (
        "no frame-shaped output in entry() result")


@pytest.mark.slow  # subprocess fallback path, same entry as standalone[8]
def test_dryrun_multichip_after_backend_init():
    """jax already initialized with 1 device: must fall back to subprocess."""
    proc = _run_clean(
        "import os\n"
        "os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=1'\n"
        "import jax\n"
        "jax.config.update('jax_platforms','cpu')\n"
        "assert len(jax.devices())==1\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK" in proc.stdout

"""The port's host preamble (``repro_torch.launch.env``) against the JAX
package's ``repro.launch.env`` on the same inputs, as the reference's env
tests in tests/test_statepack.py hold it: tcmalloc discovery, the
``--workers`` reader, the export mode's line format and ``host_env``'s
``LD_PRELOAD`` merge; then the port's own thread count, which takes the
place of the reference's XLA host device count (``OMP_NUM_THREADS`` /
``MKL_NUM_THREADS``), in process and in a launcher subprocess; and the
launchers' shared depth cut (``launch/common.py``).
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import pytest

from repro.launch import env as jenv
from repro_torch.launch import env as tenv

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
FAKE_LIB = "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4"


def test_find_tcmalloc_equals_reference():
    assert tenv.find_tcmalloc() == jenv.find_tcmalloc()
    assert tenv._TCMALLOC_GLOBS == jenv._TCMALLOC_GLOBS
    assert tenv.TCMALLOC_REPORT_THRESHOLD == jenv.TCMALLOC_REPORT_THRESHOLD


@pytest.mark.parametrize("hits", [
    [],
    ["/usr/lib64/libtcmalloc.so.4"],
    ["/usr/lib/libtcmalloc.so.4", "/usr/lib/libtcmalloc_minimal.so.4",
     "/usr/local/lib/libtcmalloc_minimal_debug.so.4"],
])
def test_find_tcmalloc_prefers_minimal_as_reference(monkeypatch, hits):
    """The same pick from the same glob hits (the minimal variant first,
    then the shortest path)."""
    def fake_glob(pat):
        return [h for h in hits if h.startswith(pat.split("libtcmalloc")[0])]

    monkeypatch.setattr(tenv.glob, "glob", fake_glob)
    monkeypatch.setattr(jenv.glob, "glob", fake_glob)
    assert tenv.find_tcmalloc() == jenv.find_tcmalloc()


@pytest.mark.parametrize("argv", [
    ["python", "-m", "x", "--workers", "12"],
    ["x", "--workers=7"],
    ["x", "--workers", "lots"],
    ["x", "--steps", "3"],
    ["x", "--workers"],
    ["x", "--workers=", "--workers", "3"],
])
def test_workers_from_argv_equals_reference(argv):
    assert tenv.workers_from_argv(argv) == jenv.workers_from_argv(argv)


@pytest.mark.parametrize("pre", [None, "", "/opt/libfoo.so",
                                 "/opt/libfoo.so:" + FAKE_LIB, FAKE_LIB])
def test_host_env_ld_preload_merge_equals_reference(monkeypatch, pre):
    """With a tcmalloc found, both merge it into the base's LD_PRELOAD
    the same way (appended once, never duplicated) and set the same
    report threshold; the base is not mutated."""
    monkeypatch.setattr(tenv, "find_tcmalloc", lambda: FAKE_LIB)
    monkeypatch.setattr(jenv, "find_tcmalloc", lambda: FAKE_LIB)
    base = {} if pre is None else {"LD_PRELOAD": pre}
    kept = dict(base)
    got = tenv.host_env(base=base)
    want = jenv.host_env(step_markers=False, base=base)
    assert got == want
    assert base == kept
    assert tenv.host_env(tcmalloc=False, base=base) == \
        jenv.host_env(tcmalloc=False, step_markers=False, base=base) == {}


def test_host_env_threads_pure_and_validating():
    env = tenv.host_env(threads=3, tcmalloc=False, base={})
    assert env == {"OMP_NUM_THREADS": "3", "MKL_NUM_THREADS": "3"}
    with pytest.raises(ValueError):
        tenv.host_env(threads=0, tcmalloc=False, base={})
    # nothing asked for: torch keeps its own choice
    assert tenv.host_env(tcmalloc=False,
                         base={"OMP_NUM_THREADS": "5"}) == {}


def _export_lines(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-m", module, "--no-tcmalloc", *args],
                       capture_output=True, text=True,
                       env={**env, "PYTHONPATH": SRC}, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout.splitlines()


def test_export_mode_line_format_equals_reference():
    """Both emit sorted ``export K='V'`` lines (``repr`` quoting); the
    port's ``--threads`` sizes the thread pools (nothing about threads
    without it), and its lines eval in a shell."""
    cmd = ["--", "python", "-m", "repro_torch.launch.train", "--workers",
           "5"]
    assert _export_lines("repro_torch.launch.env", *cmd) == []
    got = _export_lines("repro_torch.launch.env", "--threads", "2", *cmd)
    assert got == ["export MKL_NUM_THREADS='2'",
                   "export OMP_NUM_THREADS='2'"]
    want = _export_lines("repro.launch.env", *cmd)
    assert want and all(w.startswith("export ") and "='" in w
                        for w in want)
    for line in got:
        k, v = line[len("export "):].split("=", 1)
        assert v == repr(v[1:-1])
    r = subprocess.run(["bash", "-c", "\n".join(got)
                        + "\necho $OMP_NUM_THREADS"], capture_output=True,
                       text=True, timeout=60)
    assert r.stdout.strip() == "2"


def test_apply_sets_threads_before_torch_import():
    """apply(threads=...) before torch's import sizes its pool (the
    launchers' first statement); once torch is imported it resizes the
    pool with set_num_threads."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from repro_torch.launch import env as env_lib\n"
        "assert 'torch' not in sys.modules\n"
        "set_ = env_lib.apply(threads=2)\n"
        "assert set_ == {'OMP_NUM_THREADS': '2', 'MKL_NUM_THREADS': '2'}\n"
        "import torch\n"
        "assert torch.get_num_threads() == 2, torch.get_num_threads()\n"
        "env_lib.apply(threads=1)\n"
        "assert torch.get_num_threads() == 1\n"
        "print('APPLY_OK')\n" % SRC)
    env = {k: v for k, v in os.environ.items()
           if k not in tenv.THREAD_VARS}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "APPLY_OK" in r.stdout


def test_launcher_takes_host_env_threads_on_cpu():
    """A launcher started under ``host_env(threads=1)`` (what the port's
    launcher-subprocess tests pass their child) runs torch with one
    intra-op thread; the training launcher does not import the serving
    one (``--help`` stops the launcher after its flags)."""
    env = {k: v for k, v in os.environ.items()
           if k not in tenv.THREAD_VARS}
    env.update(tenv.host_env(threads=1, tcmalloc=False, base=env))
    code = ("import sys, runpy\n"
            "sys.argv = ['train', '--help']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.train', "
            "run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "import torch\n"
            "print('repro_torch.launch.serve' in sys.modules, "
            "torch.get_num_threads())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={**env, "PYTHONPATH": SRC},
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "--layers" in r.stdout and "--threads" not in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "False 1"


@pytest.mark.parametrize("arch,reduced,layers", [
    ("mixtral-8x22b", False, 4), ("kimi-k2-1t-a32b", False, 1),
    ("deepseek-7b", True, None), ("llama3-405b", True, 1)])
def test_arch_config_depth_cut(arch, reduced, layers):
    """``--arch`` reduced unless ``--full``, then cut to ``--layers``: the
    cut changes the depth alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch import common

    args = argparse.Namespace(arch=arch, reduced=reduced, layers=layers)
    cfg = common.arch_config(args)
    want = get_config(arch).reduced() if reduced else get_config(arch)
    if layers is not None:
        assert cfg.n_layers == layers
        want = dataclasses.replace(want, n_layers=layers)
    assert cfg == want


def test_arch_config_refuses_zero_layers():
    from repro_torch.launch import common

    ap = argparse.ArgumentParser()
    common.add_model_flags(ap)
    args = ap.parse_args(["--layers", "0"])
    args.arch, args.reduced = "deepseek-7b", False
    with pytest.raises(ValueError, match="--layers 0"):
        common.arch_config(args)

"""chip_smoke.py's phases at tiny sizes on the CPU.

The script is the GPU's own test; here each phase runs with its sizes
cut down, against the CPU float32 references stored in the script for
those sizes, so that a change to the engine, the phases or the stored
references shows before a chip run does.
"""
import functools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

TINY = 1 << 12

PHASES = {
    "slab": functools.partial(chip_smoke.phase_slab, n_timed=TINY,
                              n_check=TINY),
    "recorders": functools.partial(chip_smoke.phase_recorders,
                                   n_timed=TINY, n_check=256),
    "mesh": functools.partial(chip_smoke.phase_mesh, n_timed=TINY,
                              n_check=TINY),
    "gradients": functools.partial(chip_smoke.phase_gradients,
                                   n_timed=TINY, n_check=TINY),
    "sharded": lambda phase: chip_smoke.phase_sharded(
        phase, n=TINY, devices=jax.devices()[:4]
    ),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_passes_at_tiny_size(name, capsys):
    phase = chip_smoke.Phase(name)
    try:
        PHASES[name](phase)
    finally:
        phase.close()
    out = capsys.readouterr().out
    assert phase.ok, out
    assert "FAIL" not in out
    assert "check " in out


def test_references_cover_the_tiny_and_full_sizes():
    refs = chip_smoke.REFERENCES
    for name in ("slab", "mesh", "gradients"):
        assert TINY in refs[name], name
        assert chip_smoke.FULL[name]["n_check"] in refs[name], name
    for ref in refs["gradients"].values():
        assert sum(ref["fates"]) in (TINY, chip_smoke.FULL["gradients"]["n_check"])
        assert all(s > 0 for s in ref["sigma_photon"].values())


def test_fate_check_flags_a_difference_above_tolerance(capsys):
    phase = chip_smoke.Phase("fates")
    phase.close()
    n = 100_000
    ref = np.zeros(11, np.int64)
    ref[7], ref[4] = 60_000, 40_000
    near = ref.copy()
    near[7] += 100  # |d|/N = 1e-3: inside
    near[4] -= 100
    chip_smoke._check_fates(phase, near, n, ref)
    assert phase.ok
    far = ref.copy()
    far[7] += 101
    far[4] -= 101
    chip_smoke._check_fates(phase, far, n, ref)
    assert not phase.ok
    short = ref.copy()
    short[7] -= 1
    phase.ok = True
    chip_smoke._check_fates(phase, short, n)
    assert not phase.ok  # the fates must sum to N exactly


def test_main_refuses_a_cpu_platform(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert '"ok": true' not in captured.out
    assert "needs a GPU" in captured.err
    assert chip_smoke.main(["--chips", "4"]) != 0
    assert '"ok": true' not in capsys.readouterr().out

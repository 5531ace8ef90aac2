"""chip_smoke.py's own logic, on the CPU: the device gate, the seeded lane,
the expected-output construction and the byte-exact comparison."""

import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

TINY = dict(genome_len=200_000, n_barcodes=40, molecule_len=8_000,
            n_reads=2_000)


def test_gate_refuses_the_cpu():
    with pytest.raises(SystemExit) as e:
        CS.require_gpu()
    assert e.value.code not in (0, None)
    assert "GPU" in str(e.value.code)


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        CS.main([])
    assert "GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_gpu_or_repo(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:   # a directory holding chip_smoke.py and nothing else
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=str(cwd), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_lane_is_deterministic_from_its_seed():
    a_reads, a_bc = CS.make_lane(seed=3, **TINY)
    b_reads, b_bc = CS.make_lane(seed=3, **TINY)
    c_reads, _ = CS.make_lane(seed=4, **TINY)
    assert a_reads.shape == (TINY["n_reads"], CS.READ_LEN)
    assert np.array_equal(a_reads, b_reads) and np.array_equal(a_bc, b_bc)
    assert not np.array_equal(a_reads, c_reads)
    assert a_reads.max() <= 3
    assert np.array_equal(np.bincount(a_bc),
                          np.full(TINY["n_barcodes"], 50))


def test_comparison_fails_on_a_one_byte_difference():
    text = "code 0 nKmers 12 nClusters 1 sizes 12\n" * 5000
    CS.require_identical("report", text, text)
    at = len(text) - 7
    flipped = text[:at] + ("0" if text[at] != "0" else "1") + text[at + 1:]
    with pytest.raises(AssertionError, match=f"byte {at}"):
        CS.require_identical("report", flipped, text)
    with pytest.raises(AssertionError, match=f"byte {len(text) - 1}"):
        CS.require_identical("report", text[:-1], text)


def test_histogram_text_matches_engine_hashdist():
    from hash10x_jax import HashSpec
    from hash10x_jax.core.encode import pack_2bit
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io.fqb import Fqb
    from hash10x_jax.table import sorted_table as st
    reads, bc = CS.make_lane(seed=5, **TINY)
    fqb = Fqb(packed=pack_2bit(reads),
              lengths=np.full(len(reads), CS.READ_LEN, np.int32),
              barcode_ids=bc,
              barcode_keys=np.arange(TINY["n_barcodes"], dtype=np.uint32),
              read_len=CS.READ_LEN)
    eng = Engine(EngineConfig(spec=HashSpec(k=CS.K, w=CS.W, seed=CS.SEED),
                              table_bits=16, batch_reads=512), log=None)
    eng.count(fqb)
    out = io.StringIO()
    eng.write_histogram(out)
    _, counts = st.compact(eng._flushed())
    assert CS.histogram_text(np.asarray(counts)) == out.getvalue()
    assert out.getvalue().count("\n") > 3

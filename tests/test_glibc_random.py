"""GlibcRandom must match the real glibc bit-for-bit (compiled probe as oracle)."""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from hash10x_jax.glibc_random import GlibcRandom

_C_SRC = r"""
#include <stdio.h>
#include <stdlib.h>
int main(int argc, char**argv){
  srandom((unsigned)atol(argv[1]));
  int n = atoi(argv[2]);
  for (int i = 0; i < n; i++) printf("%ld\n", random());
  return 0;
}
"""


@pytest.fixture(scope="module")
def c_probe(tmp_path_factory):
    if shutil.which("gcc") is None:
        pytest.skip("no gcc available")
    d = tmp_path_factory.mktemp("grand")
    src = d / "grand.c"
    src.write_text(_C_SRC)
    exe = d / "grand"
    subprocess.run(["gcc", "-O2", "-o", str(exe), str(src)], check=True)
    return exe


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 17, 12345, 2**31 - 1, 2**32 - 1])
def test_matches_glibc(c_probe, seed):
    out = subprocess.run([str(c_probe), str(seed), "64"], check=True,
                         capture_output=True, text=True).stdout.split()
    ours = GlibcRandom(seed)
    assert [int(x) for x in out] == [ours.random() for _ in range(64)]


def test_seed_zero_equals_one():
    a, b = GlibcRandom(0), GlibcRandom(1)
    assert [a.random() for _ in range(8)] == [b.random() for _ in range(8)]

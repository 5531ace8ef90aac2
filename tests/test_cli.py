"""CLI command language end-to-end (SURVEY.md §3.1 #1: sequential commands) and
crib evaluation (#10)."""

import io

import numpy as np
import pytest

from hash10x_jax.cli.main import main
from hash10x_jax.core.encode import codes_to_ascii
from hash10x_jax.crib.crib import build_crib, genome_kmer_counts, HOM, HET1, HET2, MUL, ERR
from hash10x_jax.hashspec import HashSpec
from hash10x_jax.io.sim import SimConfig, simulate
from hash10x_jax.oracle import seqhash_ref as O

SIM = ("genome_len=200000,n_barcodes=150,molecules_per_barcode=2,"
       "molecule_len=4000,reads_per_molecule=30,read_len=120,seed=3")


def run(args):
    out, err = io.StringIO(), io.StringIO()
    rc = main(args, out=out, err=err)
    return rc, out.getvalue(), err.getvalue()


def test_help():
    rc, out, _ = run(["--help"])
    assert rc == 0 and "--readFQB" in out and "--codeClusters" in out


def test_unknown_flag():
    with pytest.raises(SystemExit):
        run(["--nonsense"])


def test_missing_arg():
    with pytest.raises(SystemExit):
        run(["-k"])


def test_sequential_pipeline(tmp_path):
    hashfile = str(tmp_path / "lane.hash")
    fqbfile = str(tmp_path / "lane.fqb")
    rc, out, err = run(["-k", "17", "-w", "7", "-r", "11", "-B", "20",
                        "--simulate", SIM, "--hashInfo", "--hashDist",
                        "--writeHash", hashfile, "--writeFQB", fqbfile,
                        "--friendShare", "20",
                        "--codeClusters", "--clusterSplit", "--clusterReport"])
    assert rc == 0
    assert "table slots" in out
    assert "code 0 nKmers" in out
    assert "[count:" in err and "[cluster:" in err  # timeUpdate lines
    # resume from the checkpoint: histogram must be identical
    rc2, out2, _ = run(["-k", "17", "-w", "7", "-r", "11", "-B", "20",
                        "--readHash", hashfile, "--hashDist"])
    assert rc2 == 0
    h1 = [l for l in out.splitlines() if "\t" in l]
    h2 = [l for l in out2.splitlines() if "\t" in l]
    assert h1 == h2
    # and the fqb can be re-read for a full re-run
    rc3, out3, _ = run(["-k", "17", "-w", "7", "-r", "11", "-B", "20",
                        "--readFQB", fqbfile + ".npz", "--friendShare", "20",
                        "--codeClusters", "--clusterReport"])
    rep1 = [l for l in out.splitlines() if l.startswith("code ")]
    rep3 = [l for l in out3.splitlines() if l.startswith("code ")]
    assert rep1 == rep3


def test_param_after_data_rejected(tmp_path):
    with pytest.raises(SystemExit):
        run(["--simulate", "genome_len=5000,n_barcodes=2,molecules_per_barcode=1,"
             "molecule_len=1000,reads_per_molecule=3,read_len=100", "-k", "19"])


def write_fasta(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">hap%d\n" % i + s + b"\n")


def test_genome_kmer_counts_matches_oracle(tmp_path, rng):
    spec = HashSpec(k=15, w=1, seed=17)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [codes_to_ascii(g)])
    # retained set = all genome kmers (canonical, deduped)
    from collections import Counter
    cnt = Counter(h for _, h, _ in O.kmer_hashes(spec, list(g)))
    retained = np.array(sorted(cnt), np.uint64)
    got = genome_kmer_counts(spec, retained, fa)
    expect = np.array([cnt[h] for h in sorted(cnt)], np.uint32)
    assert (got == expect).all()


def test_crib_labels(tmp_path, rng):
    spec = HashSpec(k=15, w=1, seed=17)
    hap1 = rng.integers(0, 4, 4000).astype(np.uint8)
    hap2 = hap1.copy()
    hap2[2000] = (hap2[2000] + 1) % 4    # one het site
    fa1, fa2 = tmp_path / "h1.fa", tmp_path / "h2.fa"
    write_fasta(fa1, [codes_to_ascii(hap1)])
    write_fasta(fa2, [codes_to_ascii(hap2)])
    from collections import Counter
    c1 = Counter(h for _, h, _ in O.kmer_hashes(spec, list(hap1)))
    c2 = Counter(h for _, h, _ in O.kmer_hashes(spec, list(hap2)))
    all_h = sorted(set(c1) | set(c2) | {12345})   # 12345 = an absent "error" hash
    retained = np.array(all_h, np.uint64)
    crib = build_crib(spec, retained, [fa1, fa2])
    for i, h in enumerate(all_h):
        a, b = c1.get(h, 0), c2.get(h, 0)
        if a == 1 and b == 1:
            assert crib.labels[i] == HOM
        elif a == 1 and b == 0:
            assert crib.labels[i] == HET1
        elif a == 0 and b == 1:
            assert crib.labels[i] == HET2
        elif a > 1 or b > 1:
            assert crib.labels[i] == MUL
        else:
            assert crib.labels[i] == ERR
    # het sites from the single SNP: k kmers on each hap become HET
    assert (crib.labels == HET1).sum() == spec.k
    assert (crib.labels == HET2).sum() == spec.k


def test_cli_crib_pipeline(tmp_path, rng):
    """Full het-sim: simulate diploid reads, crib against both haplotypes."""
    # bridge-sparse regime (cov ~4, 150 barcodes) so most barcodes split their
    # two molecules cleanly and het purity is meaningful
    sim = simulate(SimConfig(genome_len=300_000, n_barcodes=150,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=40, read_len=120,
                             het_rate=0.005, seed=4))
    fa1, fa2 = tmp_path / "h1.fa", tmp_path / "h2.fa"
    write_fasta(fa1, [codes_to_ascii(sim.genome)])
    write_fasta(fa2, [codes_to_ascii(sim.genome_hap1)])
    import hash10x_jax.io.fqb as FB
    fqb_path = str(tmp_path / "lane.fqb")
    FB.save_fqb(fqb_path, FB.from_read_batch(sim.reads))
    rc, out, err = run(["-k", "17", "-w", "7", "-B", "20",
                        "--readFQB", fqb_path + ".npz",
                        "--friendShare", "20",
                        "--codeClusters",
                        "--cribBuild", str(fa1), str(fa2),
                        "--cribReport"])
    assert rc == 0
    assert "crib totals" in out
    assert "crib overall purity" in out
    purity = float(out.rsplit("purity ", 1)[1].split()[0])
    assert purity > 0.85, f"phasing purity {purity}"


def test_syncmer_and_errorfix_commands(tmp_path):
    rc, out, err = run(["-k", "15", "-w", "5", "-B", "18", "--syncmer", "7",
                        "--simulate", "genome_len=30000,n_barcodes=8,"
                        "molecules_per_barcode=1,molecule_len=3000,"
                        "reads_per_molecule=20,read_len=100,seed=9",
                        "--hashInfo", "--errorFix", "1", "--hashInfo"])
    assert rc == 0
    infos = [l for l in out.splitlines() if l.startswith("table slots")]
    assert len(infos) == 2
    n_before = int(infos[0].split()[4])
    n_after = int(infos[1].split()[4])
    assert n_after < n_before       # error band (count<=1) removed
    assert "errorFix: dropped" in err


def test_metrics_jsonl(tmp_path):
    m = tmp_path / "metrics.jsonl"
    rc, out, err = run(["-k", "15", "-w", "5", "-B", "18",
                        "--metrics", str(m),
                        "--simulate", "genome_len=10000,n_barcodes=4,"
                        "molecules_per_barcode=1,molecule_len=2000,"
                        "reads_per_molecule=10,read_len=100,seed=9",
                        "--hashDist"])
    assert rc == 0
    import json as _json
    lines = [_json.loads(l) for l in m.read_text().splitlines()]
    assert any(l["stage"].startswith("count:") for l in lines)
    assert all("wall_s" in l and "max_rss_mb" in l for l in lines)


def test_write_counts_and_clusters(tmp_path):
    cf, clf = tmp_path / "counts.txt", tmp_path / "clusters.txt"
    rc, out, err = run(["-k", "15", "-w", "5", "-B", "18",
                        "--simulate", "genome_len=20000,n_barcodes=8,"
                        "molecules_per_barcode=1,molecule_len=3000,"
                        "reads_per_molecule=20,read_len=100,seed=9",
                        "--writeCounts", str(cf),
                        "--friendShare", "10", "--codeClusters",
                        "--writeClusters", str(clf)])
    assert rc == 0
    counts = [l.split("\t") for l in cf.read_text().splitlines()]
    hs = [int(h, 16) for h, _ in counts]
    assert hs == sorted(hs) and len(hs) > 100
    cl_lines = clf.read_text().splitlines()
    assert len(cl_lines) > 100
    code, h, lab = cl_lines[0].split("\t")
    assert int(code) == 0 and int(lab) >= 0 and int(h, 16) in set(hs)


def test_c_reference_differential(tmp_path):
    """Oracle differential test (SURVEY.md §5 item 1): our device pipeline vs
    the independent C implementation of the same contract."""
    import shutil
    import subprocess
    if shutil.which("gcc") is None:
        import pytest
        pytest.skip("no gcc")
    import numpy as np
    from pathlib import Path
    rng = np.random.default_rng(11)
    n, L = 2000, 120
    reads = rng.integers(0, 4, (n, L)).astype(np.uint8)
    binp = tmp_path / "reads.bin"
    with open(binp, "wb") as f:
        np.array([n, L], np.uint32).tofile(f)
        reads.tofile(f)
    src = Path(__file__).resolve().parent.parent / "native" / "c_ref" / "hash10x_ref.c"
    exe = tmp_path / "cref"
    subprocess.run(["gcc", "-O2", "-o", str(exe), str(src)], check=True)
    dump = tmp_path / "table.bin"
    subprocess.run([str(exe), str(binp), "21", "11", "17", "18",
                    "--dump", str(dump)], check=True, capture_output=True)
    raw = dump.read_bytes()
    m = int.from_bytes(raw[:8], "little")
    c_h = np.frombuffer(raw[8:8 + 8 * m], np.uint64)
    c_c = np.frombuffer(raw[8 + 8 * m:], np.uint32)

    from hash10x_jax.hashspec import HashSpec, U64MAX
    from hash10x_jax.core import seqhash_jnp as J
    from hash10x_jax.table import sorted_table as ST
    spec = HashSpec(k=21, w=11, seed=17)
    h, _, e = J.sketch(spec, reads, np.full(n, L, np.int32), mode="minimizer")
    flat = np.where(np.asarray(e), np.asarray(h), U64MAX).reshape(-1)
    t = ST.flush(ST.append(ST.make_sorted_table(1 << 18, 1 << 19), flat))
    our_h, our_c = ST.compact(t)
    assert (our_h == c_h).all()
    assert (our_c == c_c).all()


def test_crib_contiguity_spans(tmp_path, rng):
    """Crib report spans: clean molecule clusters span ~molecule_len."""
    sim = simulate(SimConfig(genome_len=200_000, n_barcodes=100,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=40, read_len=120, seed=6))
    fa = tmp_path / "g.fa"
    write_fasta(fa, [codes_to_ascii(sim.genome)])
    import hash10x_jax.io.fqb as FB
    fqb_path = str(tmp_path / "lane.fqb")
    FB.save_fqb(fqb_path, FB.from_read_batch(sim.reads))
    rc, out, err = run(["-k", "17", "-w", "7", "-B", "20",
                        "--readFQB", fqb_path + ".npz", "--friendShare", "20",
                        "--codeClusters", "--cribBuild", str(fa), "--cribReport"])
    assert rc == 0
    spans = []
    for l in out.splitlines():
        if " span " in l and not l.endswith("span -"):
            n = int(l.split(" n ")[1].split()[0])
            if n >= 100:  # real molecule clusters
                spans.append(int(l.rsplit("span ", 1)[1]))
    assert spans, "no spans reported"
    med = sorted(spans)[len(spans) // 2]
    assert 2000 < med < 6000, f"median span {med} not ~molecule_len"


def test_param_flags_apply_after_data():
    """Regression: tunable flags placed after a read command must take effect
    (the sequential command language contract)."""
    sim_args = ["--simulate", "genome_len=40000,n_barcodes=20,"
                "molecules_per_barcode=2,molecule_len=4000,"
                "reads_per_molecule=25,read_len=100,seed=12"]
    outs = []
    for share in ("2", "100000"):
        rc, out, err = run(["-k", "17", "-w", "7", "-B", "18", *sim_args,
                            "--friendShare", share, "--codeClusters",
                            "--clusterReport"])
        assert rc == 0
        n_cl = sum(int(l.split("nClusters ")[1].split()[0])
                   for l in out.splitlines() if l.startswith("code "))
        outs.append(n_cl)
    # an absurd share threshold yields no friends -> far more (singleton) clusters
    assert outs[1] > outs[0] * 3, outs


def test_crib_chrom_and_boundary_straddling_span():
    """Report lines carry the dominant chromosome name, and spans are
    computed over record-LOCAL positions of that chrom only — a cluster
    whose k-mers straddle a record boundary must NOT report the inflated
    concatenated-coordinate span (SURVEY.md §3.1 #10: labels + chrom/pos)."""
    import io
    from hash10x_jax.crib.crib import Crib, crib_report, HET1
    from hash10x_jax.table.incidence import build_incidence

    # 16 retained k-mers in one barcode, one cluster: 8 land at the END of
    # chr1 (concatenated pos 100..107), 8 at the START of chr2 (200..207)
    n_k = 16
    positions = np.concatenate([np.arange(100, 108), np.arange(200, 208)])
    crib = Crib(labels=np.full(n_k, HET1, np.uint8),
                hap_counts=np.ones((1, n_k), np.uint32), n_haps=1,
                positions=positions.astype(np.int64),
                rec_starts=np.array([0, 200], np.int64),
                rec_names=["chr1", "chr2"])
    inc = build_incidence(np.arange(n_k, dtype=np.int32),
                          np.zeros(n_k, np.int32), n_kmers=n_k, n_codes=1)
    out = io.StringIO()
    crib_report(inc, np.zeros(n_k, np.int64), crib, out)
    line = [l for l in out.getvalue().splitlines()
            if l.startswith("code 0 cluster 0")][0]
    # tie at 8 vs 8 k-mers -> smallest record id wins: chr1
    assert " chrom chr1 " in line, line
    span = int(line.rsplit("span ", 1)[1])
    # chr1-local inner-80% of [100..107] is ~5-6; the straddling
    # concatenated span would be ~96
    assert span < 10, line

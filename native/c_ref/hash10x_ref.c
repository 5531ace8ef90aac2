/* hash10x_ref.c — C reference implementation of the hash10x_jax contract.
 *
 * Written from this framework's documented spec (hash10x_jax/hashspec.py,
 * oracle/seqhash_ref.py, oracle/cluster_ref.py) — NOT copied from
 * richarddurbin/hash10x (whose source was unavailable; SURVEY.md §0).
 * Purpose:
 *   1. the single-thread C baseline ("x1.0 row") for bench.py's vs_baseline,
 *      standing in for the reference binary per BASELINE.md — now covering
 *      the FULL pipeline (barcodes-mode count + band filter + incidence +
 *      friend clustering + split + report), not just config-#1 counting;
 *   2. a differential oracle: --dump emits the sorted (hash,count) table and
 *      --dumpClusters emits the (code, kmer hash, cluster) assignment text
 *      for bit-exact comparison with the device pipeline
 *      (engine.write_counts / engine.write_clusters surfaces).
 *
 * Usage: hash10x_ref <reads.bin> <k> <w> <seed> <tableBits>
 *          [--barcodes bc.bin] [--minCount n] [--maxCount n]
 *          [--friendShare n] [--cluster] [--report out.txt]
 *          [--dump out.bin] [--dumpClusters out.txt]
 *   reads.bin: u32 n, u32 L, then n*L uint8 base codes (0..3).
 *   bc.bin:    n u32 barcode ids (dense, 0..n_codes-1).
 * Without --barcodes: occurrence-mode minimizer counts (config #1), one
 * line "reads <n> kmers <distinct> emitted <total> seconds <s>".
 * With --barcodes: counts = distinct barcodes per hash; --cluster runs the
 * band filter + per-barcode friend clustering (oracle/cluster_ref.py
 * cluster_barcode_friend, max_friends uncapped) + split, and the timing
 * line gains "pairs <n> molecules <m> cluster_seconds <s>".
 */

#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include <string.h>
#include <time.h>

typedef uint64_t U64;
typedef uint32_t U32;
typedef uint8_t U8;

static U64 factor1, mask, patternRC[4];
static int shift1, K, W;

static void spec_init(int k, int w, unsigned seed) {
  srandom(seed);
  U64 r1 = (U64)random(), r2 = (U64)random();
  factor1 = (r1 << 32) | r2 | 1u;
  shift1 = 64 - 2 * k;
  mask = (((U64)1) << (2 * k)) - 1;
  for (int i = 0; i < 4; i++) patternRC[i] = ((U64)(3 - i)) << (2 * (k - 1));
  K = k; W = w;
}

static inline U64 hashF(U64 x) { return (x * factor1) >> shift1; }

/* open-addressing count table, linear probe, keys=hash (U64MAX empty) */
static U64 *tkeys; static U32 *tcounts; static U64 tmask; static U64 tfilled;

static void table_init(int bits) {
  U64 s = ((U64)1) << bits;
  tkeys = malloc(s * sizeof(U64));
  tcounts = calloc(s, sizeof(U32));
  memset(tkeys, 0xff, s * sizeof(U64));
  tmask = s - 1;
  tfilled = 0;
}

static inline void table_add(U64 h) {
  U64 s = h & tmask;
  for (;;) {
    if (tkeys[s] == h) { tcounts[s]++; return; }
    if (tkeys[s] == ~(U64)0) { tkeys[s] = h; tcounts[s] = 1; tfilled++; return; }
    s = (s + 1) & tmask;
  }
}

static double now_s(void) {
  struct timespec t; clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

/* ---- barcodes mode: (hash, code) pair machinery ---- */

typedef struct { U64 h; U32 c; } Pair;

static int pair_cmp_hc(const void *a, const void *b) {
  const Pair *x = a, *y = b;
  if (x->h != y->h) return x->h < y->h ? -1 : 1;
  return x->c < y->c ? -1 : x->c > y->c ? 1 : 0;
}

static int pair_cmp_ch(const void *a, const void *b) {
  const Pair *x = a, *y = b;
  if (x->c != y->c) return x->c < y->c ? -1 : 1;
  return x->h < y->h ? -1 : x->h > y->h ? 1 : 0;
}

static int u64_cmp(const void *a, const void *b) {
  U64 x = *(const U64 *)a, y = *(const U64 *)b;
  return x < y ? -1 : x > y ? 1 : 0;
}

/* union-find over one barcode's k-mer slots (oracle/cluster_ref.py) */
static int uf_find(int *parent, int x) {
  while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
  return x;
}
static void uf_union(int *parent, int a, int b) {
  int ra = uf_find(parent, a), rb = uf_find(parent, b);
  if (ra != rb) { if (ra < rb) parent[rb] = ra; else parent[ra] = rb; }
}

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s reads.bin k w seed bits [--barcodes f] "
            "[--minCount n] [--maxCount n] [--friendShare n] [--cluster] "
            "[--report f] [--dump f] [--dumpClusters f]\n", argv[0]);
    return 2;
  }
  FILE *f = fopen(argv[1], "rb");
  if (!f) { perror("reads"); return 1; }
  U32 n, L;
  if (fread(&n, 4, 1, f) != 1 || fread(&L, 4, 1, f) != 1) return 1;
  U8 *reads = malloc((size_t)n * L);
  if (fread(reads, 1, (size_t)n * L, f) != (size_t)n * L) return 1;
  fclose(f);

  int k = atoi(argv[2]), w = atoi(argv[3]), bits = atoi(argv[5]);
  spec_init(k, w, (unsigned)atol(argv[4]));
  table_init(bits);

  /* options */
  const char *bc_path = 0, *dump_path = 0, *dumpcl_path = 0, *report_path = 0;
  int min_count = 2, max_count = 64, friend_share = 8, do_cluster = 0;
  for (int a = 6; a < argc; a++) {
    if (!strcmp(argv[a], "--barcodes") && a + 1 < argc) bc_path = argv[++a];
    else if (!strcmp(argv[a], "--minCount") && a + 1 < argc) min_count = atoi(argv[++a]);
    else if (!strcmp(argv[a], "--maxCount") && a + 1 < argc) max_count = atoi(argv[++a]);
    else if (!strcmp(argv[a], "--friendShare") && a + 1 < argc) friend_share = atoi(argv[++a]);
    else if (!strcmp(argv[a], "--cluster")) do_cluster = 1;
    else if (!strcmp(argv[a], "--report") && a + 1 < argc) report_path = argv[++a];
    else if (!strcmp(argv[a], "--dump") && a + 1 < argc) dump_path = argv[++a];
    else if (!strcmp(argv[a], "--dumpClusters") && a + 1 < argc) dumpcl_path = argv[++a];
    else { fprintf(stderr, "unknown arg %s\n", argv[a]); return 2; }
  }

  U32 *bc = 0; U32 n_codes = 0;
  if (bc_path) {
    FILE *bf = fopen(bc_path, "rb");
    if (!bf) { perror("barcodes"); return 1; }
    bc = malloc((size_t)n * 4);
    if (fread(bc, 4, n, bf) != n) return 1;
    fclose(bf);
    for (U32 i = 0; i < n; i++) if (bc[i] + 1 > n_codes) n_codes = bc[i] + 1;
  }

  int P = (int)L - k + 1;
  U64 *hv = malloc(P * sizeof(U64));
  U8 *emit = malloc(P);
  U64 emitted = 0;
  /* barcodes mode keeps every (hash, code) emission for the exact
   * distinct-barcode counts + incidence build (sort+dedup, the scalar
   * golden-model discipline — memory ~ emissions x 16 B) */
  size_t pr_cap = bc ? ((size_t)n * (2 * P / (w + 1) + 2) + 1024) : 0;
  Pair *pr = bc ? malloc(pr_cap * sizeof(Pair)) : 0;
  size_t n_pr = 0;

  double t0 = now_s();
  for (U32 r = 0; r < n; r++) {
    const U8 *s = reads + (size_t)r * L;
    U64 h = 0, hrc = 0;
    /* rolling canonical hashes of every k-mer (hashspec.py contract) */
    for (int i = 0; i < (int)L; i++) {
      U64 b = s[i];
      h = ((h << 2) | b) & mask;
      hrc = (hrc >> 2) | patternRC[b];
      if (i >= k - 1) {
        U64 hf = hashF(h), hr = hashF(hrc);
        hv[i - k + 1] = hf < hr ? hf : hr;
      }
    }
    /* leftmost-minimum w-window minimizer set (seqhash_ref.minimizers) */
    memset(emit, 0, P);
    int ww = w < P ? w : P;
    for (int st = 0; st + ww <= P; st++) {
      int best = st;
      for (int j = st + 1; j < st + ww; j++)
        if (hv[j] < hv[best]) best = j;
      emit[best] = 1;
    }
    for (int i = 0; i < P; i++)
      if (emit[i]) {
        emitted++;
        if (bc) {
          if (n_pr == pr_cap) {
            pr_cap += pr_cap / 2;
            pr = realloc(pr, pr_cap * sizeof(Pair));
          }
          pr[n_pr].h = hv[i]; pr[n_pr].c = bc[r]; n_pr++;
        } else table_add(hv[i]);
      }
  }

  U64 n_distinct = tfilled;
  if (bc) {
    /* distinct-barcode counts: sort (hash, code), dedup, run-length count */
    qsort(pr, n_pr, sizeof(Pair), pair_cmp_hc);
    size_t m = 0;
    for (size_t i = 0; i < n_pr; i++)
      if (!m || pr[i].h != pr[m - 1].h || pr[i].c != pr[m - 1].c)
        pr[m++] = pr[i];
    n_pr = m;
    if (n_pr > tmask + 1) {  /* the dense list can outgrow the table */
      tkeys = realloc(tkeys, n_pr * sizeof(U64));
      tcounts = realloc(tcounts, n_pr * sizeof(U32));
    }
    for (size_t i = 0, j; i < n_pr; i = j) {
      for (j = i; j < n_pr && pr[j].h == pr[i].h; j++) ;
      tkeys[tfilled] = pr[i].h;       /* reuse table arrays as a dense list */
      tcounts[tfilled] = (U32)(j - i);
      tfilled++;
    }
    n_distinct = tfilled;
  }
  double count_s = now_s() - t0;

  /* ---- clustering (barcodes mode): band filter -> incidence -> friend
   * clustering per barcode -> split (oracle/cluster_ref.py semantics) ---- */
  double cluster_s = 0; size_t kept_pairs = 0; U64 n_molecules = 0;
  U32 *cl_labels = 0; Pair *inc = 0; size_t n_inc = 0;
  U64 *retained = 0; size_t n_ret = 0;
  size_t *code_off = 0;
  if (bc && do_cluster) {
    t0 = now_s();
    /* retained set: sorted distinct hashes whose count is in the band
     * (tkeys[0..tfilled) is already hash-ascending from the pair sort) */
    retained = malloc(tfilled * sizeof(U64));
    for (U64 i = 0; i < tfilled; i++)
      if (tcounts[i] >= (U32)min_count && tcounts[i] <= (U32)max_count)
        retained[n_ret++] = tkeys[i];
    /* incidence: (rank, code) pairs of retained hashes, then code-major */
    inc = malloc(n_pr * sizeof(Pair));
    for (size_t i = 0; i < n_pr; i++) {
      /* binary search rank of pr[i].h in retained */
      size_t lo = 0, hi = n_ret;
      while (lo < hi) { size_t mid = (lo + hi) / 2;
        if (retained[mid] < pr[i].h) lo = mid + 1; else hi = mid; }
      if (lo < n_ret && retained[lo] == pr[i].h) {
        inc[n_inc].h = lo; inc[n_inc].c = pr[i].c; n_inc++;
      }
    }
    qsort(inc, n_inc, sizeof(Pair), pair_cmp_ch);   /* code-major CSR */
    kept_pairs = n_inc;
    /* CSR offsets per code, and the inverted kmer->codes lists */
    code_off = calloc(n_codes + 2, sizeof(size_t));
    for (size_t i = 0; i < n_inc; i++) code_off[inc[i].c + 1]++;
    for (U32 c = 0; c < n_codes; c++) code_off[c + 1] += code_off[c];
    Pair *invp = malloc(n_inc * sizeof(Pair));
    memcpy(invp, inc, n_inc * sizeof(Pair));
    qsort(invp, n_inc, sizeof(Pair), pair_cmp_hc);  /* kmer-major */
    size_t *kmer_off = calloc(n_ret + 2, sizeof(size_t));
    for (size_t i = 0; i < n_inc; i++) kmer_off[invp[i].h + 1]++;
    for (size_t kk = 0; kk < n_ret; kk++) kmer_off[kk + 1] += kmer_off[kk];

    /* friend clustering per barcode (cluster_barcode_friend, no cap) */
    cl_labels = malloc(n_inc * sizeof(U32));
    U32 *share = calloc(n_codes, sizeof(U32));
    U32 *touched = malloc(n_codes * sizeof(U32));
    int *first_with = malloc(n_codes * sizeof(int));
    int max_k = 0;
    for (U32 c = 0; c < n_codes; c++) {
      int kc = (int)(code_off[c + 1] - code_off[c]);
      if (kc > max_k) max_k = kc;
    }
    int *parent = malloc((max_k > 0 ? max_k : 1) * sizeof(int));
    int *remap = malloc((max_k > 0 ? max_k : 1) * sizeof(int));
    for (U32 c = 0; c < n_codes; c++) {
      size_t b0 = code_off[c], b1 = code_off[c + 1];
      int kc = (int)(b1 - b0);
      if (!kc) continue;
      /* share tally over other barcodes */
      size_t n_touch = 0;
      for (size_t i = b0; i < b1; i++) {
        U64 kk = inc[i].h;
        for (size_t j = kmer_off[kk]; j < kmer_off[kk + 1]; j++) {
          U32 c2 = invp[j].c;
          if (c2 == c) continue;
          if (!share[c2]) touched[n_touch++] = c2;
          share[c2]++;
        }
      }
      /* friend set: share >= friend_share; link this barcode's k-mers
       * through each friend (first_with discipline of the oracle) */
      for (size_t t = 0; t < n_touch; t++)
        first_with[touched[t]] = -1;
      for (int i = 0; i < kc; i++) parent[i] = i;
      for (int i = 0; i < kc; i++) {
        U64 kk = inc[b0 + i].h;
        for (size_t j = kmer_off[kk]; j < kmer_off[kk + 1]; j++) {
          U32 c2 = invp[j].c;
          if (c2 == c || share[c2] < (U32)friend_share) continue;
          if (first_with[c2] < 0) first_with[c2] = i;
          else uf_union(parent, first_with[c2], i);
        }
      }
      /* canonical labels: first-appearing k-mer numbering */
      int next = 0;
      for (int i = 0; i < kc; i++) remap[i] = -1;
      for (int i = 0; i < kc; i++) {
        int root = uf_find(parent, i);
        if (remap[root] < 0) remap[root] = next++;
        cl_labels[b0 + i] = (U32)remap[root];
      }
      n_molecules += (U64)next;
      for (size_t t = 0; t < n_touch; t++) share[touched[t]] = 0;
    }
    free(share); free(touched); free(first_with); free(parent); free(remap);
    free(invp); free(kmer_off);
    cluster_s = now_s() - t0;
  }

  printf("reads %u kmers %llu emitted %llu seconds %.6f", n,
         (unsigned long long)n_distinct, (unsigned long long)emitted, count_s);
  if (bc && do_cluster)
    printf(" pairs %zu molecules %llu cluster_seconds %.6f",
           kept_pairs, (unsigned long long)n_molecules, cluster_s);
  printf("\n");

  if (dump_path) {
    /* sorted (hash,count) pairs for differential comparison; barcodes mode
     * already left tkeys/tcounts dense and hash-ascending */
    U64 m = 0;
    U64 *hs = malloc(tfilled * sizeof(U64));
    U32 *cs = malloc(tfilled * sizeof(U32));
    if (bc) {
      for (U64 i = 0; i < tfilled; i++) { hs[i] = tkeys[i]; cs[i] = tcounts[i]; }
      m = tfilled;
    } else {
      U64 sz = tmask + 1;
      U64 *idx = malloc(tfilled * sizeof(U64));
      for (U64 i = 0; i < sz; i++)
        if (tkeys[i] != ~(U64)0) { hs[m] = tkeys[i]; cs[m] = tcounts[i]; idx[m] = m; m++; }
      /* sort by hash carrying counts: sort an index permutation */
      U64 *hs2 = malloc(m * sizeof(U64)); U32 *cs2 = malloc(m * sizeof(U32));
      qsort(hs, m, sizeof(U64), u64_cmp); /* counts re-derived below */
      /* counts must follow their hashes: rebuild by re-probing the table */
      for (U64 i = 0; i < m; i++) {
        U64 h = hs[i], s = h & tmask;
        while (tkeys[s] != h) s = (s + 1) & tmask;
        cs[i] = tcounts[s];
      }
      free(hs2); free(cs2); free(idx);
    }
    FILE *o = fopen(dump_path, "wb");
    fwrite(&m, 8, 1, o);
    fwrite(hs, 8, m, o);
    fwrite(cs, 4, m, o);
    fclose(o);
    free(hs); free(cs);
  }

  if (dumpcl_path && cl_labels) {
    /* text identical to engine.write_clusters: "code\thashhex\tlabel" per
     * pair, code-major then kmer-rank ascending */
    FILE *o = fopen(dumpcl_path, "w");
    for (size_t i = 0; i < n_inc; i++)
      fprintf(o, "%u\t%llx\t%u\n", inc[i].c,
              (unsigned long long)retained[inc[i].h], cl_labels[i]);
    fclose(o);
  }

  if (report_path && cl_labels) {
    /* text identical to engine report lines: "code c nKmers k nClusters m
     * sizes a,b,c" — cluster sizes in label order per code */
    FILE *o = fopen(report_path, "w");
    U32 *sizes = malloc((n_inc ? n_inc : 1) * sizeof(U32));
    for (U32 c = 0; c < n_codes; c++) {
      size_t b0 = code_off[c], b1 = code_off[c + 1];
      U32 n_cl = 0;
      for (size_t i = b0; i < b1; i++)
        if (cl_labels[i] + 1 > n_cl) n_cl = cl_labels[i] + 1;
      for (U32 l = 0; l < n_cl; l++) sizes[l] = 0;
      for (size_t i = b0; i < b1; i++) sizes[cl_labels[i]]++;
      fprintf(o, "code %u nKmers %zu nClusters %u sizes ", c, b1 - b0, n_cl);
      for (U32 l = 0; l < n_cl; l++)
        fprintf(o, "%s%u", l ? "," : "", sizes[l]);
      fprintf(o, "\n");
    }
    free(sizes);
    fclose(o);
  }
  return 0;
}

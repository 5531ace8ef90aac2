/* h10x_loader.c — native FASTQ → packed-read loader for hash10x-jax.
 *
 * The host-side data-loader must keep the device fed (SURVEY.md §4.5: host ingest
 * overlaps device compute); this C path fuses FASTQ record parsing, base→2-bit
 * packing, and 16bp GEM barcode extraction into one OpenMP-parallel pass over the
 * mmap'd buffer — the native equivalent of the reference's readseq layer
 * (SURVEY.md §3.1 #17) plus the FASTQ→FQB converter (#3).
 *
 * Exposed via ctypes (hash10x_jax/io/native_loader.py); falls back to the numpy
 * parser when no compiler is available.
 *
 * Layout contract (must match io/fqb.py):
 *   packed[rec][w]: uint32, base j of the post-barcode sequence in bits (2j mod 32)
 *   lengths[rec]  : int32 post-barcode length (0 if invalid barcode/too short)
 *   barcodes[rec] : uint32 2-bit packed 16bp barcode, base 0 in the TOP bits;
 *                   0xFFFFFFFF when the barcode contains a non-ACGT base
 *   nmask[rec][w] : uint32 invalid-base bitmask (bit j%32 of word j/32 set iff
 *                   base j is not ACGT) — k-mers spanning an N must not count
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef H10X_HAVE_ZLIB
#include <zlib.h>
#endif

static const uint8_t LUT[256] = {
    /* init to 4 = invalid; a/A=0 c/C=1 g/G=2 t/T=3 patched below in init */
};

static uint8_t lut[256];

__attribute__((constructor)) static void init_lut(void) {
  memset(lut, 4, 256);
  lut['a'] = lut['A'] = 0;
  lut['c'] = lut['C'] = 1;
  lut['g'] = lut['G'] = 2;
  lut['t'] = lut['T'] = 3;
}

#ifdef H10X_HAVE_ZLIB
/* Inflate a .gz (or plain) file into a C-allocated buffer via zlib's gzread
 * (transparent for uncompressed input), realloc-doubling — the gzip path of
 * the loader stays native end to end instead of decompressing in Python
 * first.  Returns the byte length and stores the buffer through *out (caller
 * must h10x_free it); -1 on any error. */
long h10x_gz_read(const char *path, void **out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  gzbuffer(f, 1u << 20);
  size_t cap = 1u << 24, n = 0;
  char *buf = (char *)malloc(cap);
  if (!buf) { gzclose(f); return -1; }
  for (;;) {
    if (n == cap) {
      cap *= 2;
      char *nb = (char *)realloc(buf, cap);
      if (!nb) { free(buf); gzclose(f); return -1; }
      buf = nb;
    }
    size_t want = cap - n;
    if (want > (1u << 30)) want = 1u << 30;
    int got = gzread(f, buf + n, (unsigned)want);
    if (got < 0) { free(buf); gzclose(f); return -1; }
    if (got == 0) break;
    n += (size_t)got;
  }
  gzclose(f);
  *out = buf;
  return (long)n;
}

void h10x_free(void *p) { free(p); }
#endif

/* Count FASTQ records (lines / 4). */
long h10x_count_records(const char *buf, long n) {
  long lines = 0;
#pragma omp parallel for reduction(+ : lines) schedule(static)
  for (long i = 0; i < n; i++)
    if (buf[i] == '\n') lines++;
  if (n > 0 && buf[n - 1] != '\n') lines++;
  return lines / 4;
}

/* Pass 1: record the byte offset of every record's sequence line.
 * offsets must hold n_records entries. Single-threaded (cheap). */
long h10x_seq_offsets(const char *buf, long n, long *seq_off, long *seq_len,
                      long max_records) {
  long rec = 0, i = 0;
  while (i < n && rec < max_records) {
    /* header line */
    if (buf[i] != '@') return -1;
    while (i < n && buf[i] != '\n') i++;
    i++;
    if (i >= n) break;
    long s = i;
    while (i < n && buf[i] != '\n') i++;
    seq_off[rec] = s;
    seq_len[rec] = i - s;
    rec++;
    i++;
    /* plus line */
    while (i < n && buf[i] != '\n') i++;
    i++;
    /* quality line */
    while (i < n && buf[i] != '\n') i++;
    i++;
  }
  return rec;
}

/* Pass 2 (parallel): pack every record. words = ceil(max_len/16),
 * nwords = ceil(max_len/32). Returns the number of set nmask bits (0 = the
 * caller may drop the mask entirely). */
long h10x_pack(const char *buf, const long *seq_off, const long *seq_len,
               long n_rec, int bc_len, int max_len, int words, int nwords,
               uint32_t *packed, int32_t *lengths, uint32_t *barcodes,
               uint32_t *nmask) {
  long n_bad = 0;
#pragma omp parallel for schedule(static) reduction(+ : n_bad)
  for (long r = 0; r < n_rec; r++) {
    const char *s = buf + seq_off[r];
    long len = seq_len[r];
    uint32_t bc = 0;
    int bad = 0;
    memset(nmask + (size_t)r * nwords, 0, (size_t)nwords * 4);
    if (len <= bc_len) {
      barcodes[r] = 0xFFFFFFFFu;
      lengths[r] = 0;
      memset(packed + (size_t)r * words, 0, (size_t)words * 4);
      continue;
    }
    for (int j = 0; j < bc_len; j++) {
      uint8_t c = lut[(uint8_t)s[j]];
      if (c > 3) bad = 1;
      bc = (bc << 2) | (c & 3);
    }
    barcodes[r] = bad ? 0xFFFFFFFFu : bc;
    long sl = len - bc_len;
    if (sl > max_len) sl = max_len;
    lengths[r] = bad ? 0 : (int32_t)sl;
    uint32_t *row = packed + (size_t)r * words;
    uint32_t *nrow = nmask + (size_t)r * nwords;
    memset(row, 0, (size_t)words * 4);
    const char *q = s + bc_len;
    for (long j = 0; j < sl; j++) {
      uint8_t c = lut[(uint8_t)q[j]];
      if (c > 3) { /* N: pack as 'a', flag in the sideband */
        c = 0;
        if (!bad) { /* bad-barcode reads have length 0: no mask needed */
          nrow[j >> 5] |= ((uint32_t)1) << (j & 31);
          n_bad++;
        }
      }
      row[j >> 4] |= ((uint32_t)c) << ((j & 15) * 2);
    }
  }
  return n_bad;
}

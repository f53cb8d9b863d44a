#!/usr/bin/env bash
# Sanitizer runs for the port's multithreaded native code (BgzfMT block
# decode, parallel CRAM container decode, the extract engine's producer
# thread): TSAN on clean scans, ASAN+UBSAN over a malformed-CRAM fuzz corpus
# and over arith / fqzcomp / tok3 codec blobs. Port of the JAX package's
# scripts/sanitize.sh over strling_tpu_torch/io/csrc, run for two builds:
#   system  linked as a host with libdeflate's and liblzma's headers links it
#   compat  linked as a GPU host without them links it (io/hostlib.py): the
#           zlib-backed libdeflate shim (io/compat/libdeflate_zlib.cc), the
#           compat headers, liblzma and libbz2 by soname
# Usage: strling_tpu_torch/scripts/sanitize.sh <bam> <cram> <fasta>
#   (SANITIZE_BUILDS="system compat" by default; the fuzz corpus is made on
#   the fly from the cram, as tests/test_torch_cram.py's malformed-CRAM test
#   makes its cases; the codec blobs come from the port's io/cramwrite.py)
set -euo pipefail
cd "$(dirname "$0")/../.."
BAM=${1:?bam}; CRAM=${2:?cram}; FASTA=${3:?fasta}
BUILDS=${SANITIZE_BUILDS:-system compat}
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
SRC=strling_tpu_torch/io/csrc
COMPAT=strling_tpu_torch/io/compat
FLAGS=(-O1 -g -march=native -std=c++17 -pthread)

soname() {  # a shared library by soname, as io/hostlib.py finds it
  for d in /lib/x86_64-linux-gnu /usr/lib/x86_64-linux-gnu /lib64 /usr/lib64 /usr/lib; do
    if [ -e "$d/$1" ]; then echo "$d/$1"; return; fi
  done
  echo "$2"
}
BZ2LIB=$(soname libbz2.so.1.0 -lbz2)
LZMALIB=$(soname liblzma.so.5 -llzma)

cat > "$TMP/scan.cc" <<'EOF'
#include <cstdio>
#include <cstdint>
#include <cstdlib>
extern "C" {
  void* sio_open(const char* path);
  int sio_set_fasta(void* h, const char* path);
  void sio_close(void* h);
  int sio_begin(void* h, int mode, int tid, int64_t beg, int64_t end);
  int64_t sio_next_batch(void* vh, int64_t cap, int Lmax, int32_t* tid,
                         int32_t* pos, uint16_t* flag, uint8_t* mapq,
                         int32_t* mate_tid, int32_t* mate_pos, int32_t* isize,
                         int32_t* read_len, int32_t* end_pos, int32_t* lclip,
                         int32_t* rclip, int32_t* ins_sum, int32_t* del_sum,
                         uint8_t* seq, uint32_t* cigar_buf, int64_t cigar_cap,
                         int64_t* cigar_off, char* qname_buf, int64_t qname_cap,
                         int64_t* qname_off);
}
int main(int argc, char** argv) {
  void* h = sio_open(argv[1]);
  if (!h) { fprintf(stderr, "open failed\n"); return 1; }
  if (argc > 2 && argv[2][0]) sio_set_fasta(h, argv[2]);
  const int64_t CAP = 4096; const int L = 160;
  static int32_t tid[CAP], pos[CAP], mtid[CAP], mpos[CAP], isz[CAP], rl[CAP],
      ep[CAP], lc[CAP], rc[CAP], ins[CAP], del[CAP];
  static uint16_t flag[CAP]; static uint8_t mapq[CAP];
  static uint8_t seq[CAP * L]; static uint32_t cig[CAP * 64];
  static int64_t coff[CAP + 1]; static char qn[CAP * 64];
  static int64_t qoff[CAP + 1];
  int64_t total = 0, n;
  sio_begin(h, 0, -1, 0, 0);
  while ((n = sio_next_batch(h, CAP, L, tid, pos, flag, mapq, mtid, mpos, isz,
                             rl, ep, lc, rc, ins, del, seq, cig, CAP * 64,
                             coff, qn, CAP * 64, qoff)) > 0)
    total += n;
  printf("total=%ld\n", (long)total);
  sio_close(h);
  return n < 0 ? 3 : 0;
}
EOF

cat > "$TMP/codec.cc" <<'EOF'
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
extern "C" {
  int64_t sio_arith_decode(const uint8_t*, int64_t, int64_t, uint8_t*, int64_t);
  int64_t sio_fqz_decode(const uint8_t*, int64_t, int64_t, uint8_t*, int64_t);
  int64_t sio_tok3_decode(const uint8_t*, int64_t, int64_t, uint8_t*, int64_t);
}
int main(int argc, char** argv) {
  // argv: mode blobfile usize — truncations + bit flips, in-process
  FILE* f = fopen(argv[2], "rb");
  fseek(f, 0, SEEK_END); long n = ftell(f); fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> blob(n);
  if (fread(blob.data(), 1, n, f) != (size_t)n) return 2;
  fclose(f);
  int64_t usize = atoll(argv[3]);
  std::vector<uint8_t> out(usize + 64);
  auto dec = !strcmp(argv[1], "arith") ? sio_arith_decode
           : !strcmp(argv[1], "tok3") ? sio_tok3_decode : sio_fqz_decode;
  unsigned seed = 12345;
  for (long cut = 0; cut <= n; cut += 13)
    dec(blob.data(), cut, usize, out.data(), out.size());
  for (int i = 0; i < 300; i++) {
    std::vector<uint8_t> m = blob;
    for (int j = 0; j < 1 + (int)(rand_r(&seed) % 8); j++)
      m[rand_r(&seed) % n] ^= 1 << (rand_r(&seed) % 8);
    dec(m.data(), n, usize, out.data(), out.size());
  }
  printf("ok\n");
  return 0;
}
EOF

cat > "$TMP/engine.cc" <<'CCEOF'
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
extern "C" {
  void* sio_open(const char* path);
  void sio_close(void* h);
  void* sio_ex_create(void* h, double prop, int mapq, int64_t med, int Lmax);
  void sio_ex_destroy(void* e);
  int64_t sio_ex_next_fused(void* e, int64_t maxrec, int64_t* nrec,
                            uint8_t* payload, uint8_t* ab, int32_t* al,
                            double* ap, int64_t cap, int32_t* fb);
  int sio_ex_feed(void* e, const int32_t* c, const int32_t* l,
                  const int32_t* n, int64_t rows);
  int sio_ex_done(void* e);
  int64_t sio_ex_n_treads(void* e);
  int64_t sio_ex_get_treads(void* e, int32_t* tid, uint32_t* pos,
                            uint8_t* rep6, uint16_t* flag, uint8_t* split,
                            uint8_t* mapq, uint8_t* cnt, uint8_t* alen,
                            char* qbuf, int64_t qcap, int64_t* qoff);
  int sio_ex_set_median(void* e, int64_t median);
  int sio_ex_set_hist_tee(void* e, int64_t skip, int64_t n);
  int sio_ex_hist_ready(void* e);
  int sio_ex_get_hist(void* e, uint32_t* hist, int32_t* max_len);
  int sio_ex_set_trace(void* e, int on);
  int64_t sio_ex_counters(void* e, int64_t* out, int64_t n);
  int64_t sio_ex_trace_events(void* e, int64_t* out, int64_t cap);
  void sio_hubers_batch(const double* X, int64_t L, int64_t S, double c,
                        double tol, int64_t maxiter, double gamma,
                        double* mu, double* sd, uint8_t* meth);
}
int main(int argc, char** argv) {
  void* h = sio_open(argv[1]);
  if (!h) return 1;
  const int Lmax = 160;
  const int64_t CAP = 8192;
  // the median pending, and set between the third and fourth feeds: the
  // patch of the treads fed before it runs under the sanitizer
  void* e = sio_ex_create(h, 0.8, 40, -1, Lmax);
  // hist tee: producer writes, this thread polls/reads — the exact
  // cross-thread pattern extract_native uses (fh_ready acquire gate)
  if (sio_ex_set_hist_tee(e, 100, 100000) != 0) return 4;
  // spans and counters: the producer and the inflate workers write them,
  // this thread reads them once the pass has drained
  if (sio_ex_set_trace(e, 1) != 0) return 6;
  bool hist_read = false;
  uint32_t hist[4096];
  int32_t hmax = 0;
  std::vector<uint8_t> payload((size_t)CAP * (3 * Lmax / 8 + 22));
  std::vector<uint8_t> ab((size_t)CAP * Lmax);
  std::vector<int32_t> al(CAP);
  std::vector<double> ap(CAP);
  // every scanned row reads as a 255-base run of A, every prefiltered one
  // as no repeat: pairs of the two make treads whose positions take the
  // median's term
  std::vector<int32_t> code(CAP, 0), ulen(CAP, 1), count(CAP, 255);
  int64_t total = 0, feeds = 0;
  for (;;) {
    int64_t nrec = 0; int32_t fb = 0;
    int64_t rows = sio_ex_next_fused(e, 4000, &nrec, payload.data(), ab.data(),
                                     al.data(), ap.data(), CAP, &fb);
    if (rows < 0) return 3;
    total += nrec;
    if (!hist_read && sio_ex_hist_ready(e)) {
      if (sio_ex_get_hist(e, hist, &hmax) != 0) return 5;
      hist_read = true;
    }
    if (nrec > 0) {
      if (sio_ex_feed(e, code.data(), ulen.data(), count.data(), rows) != 0)
        return 8;
      if (++feeds == 3 && sio_ex_set_median(e, 400) != 0) return 9;
    }
    if (nrec == 0 && sio_ex_done(e)) break;
  }
  if (feeds < 3 && sio_ex_set_median(e, 400) != 0) return 9;
  if (!hist_read && sio_ex_get_hist(e, hist, &hmax) != 0) return 5;
  const int64_t nt = sio_ex_n_treads(e);
  std::vector<int32_t> ttid(nt + 1);
  std::vector<uint32_t> tpos(nt + 1);
  std::vector<uint8_t> trep(6 * nt + 6), tsplit(nt + 1), tmapq(nt + 1),
      tcnt(nt + 1), talen(nt + 1);
  std::vector<uint16_t> tflag(nt + 1);
  std::vector<char> qbuf(256 * nt + 16);
  std::vector<int64_t> qoff(nt + 1);
  if (sio_ex_get_treads(e, ttid.data(), tpos.data(), trep.data(),
                        tflag.data(), tsplit.data(), tmapq.data(),
                        tcnt.data(), talen.data(), qbuf.data(),
                        (int64_t)qbuf.size(), qoff.data()) != nt)
    return 10;
  int64_t ctr[16];
  const int64_t n_ctr = sio_ex_counters(e, ctr, 16);
  if (n_ctr != 12) return 11;
  const int64_t n_ev = sio_ex_trace_events(e, nullptr, 0);
  std::vector<int64_t> ev((size_t)(6 * n_ev + 6));
  if (sio_ex_trace_events(e, ev.data(), n_ev) != n_ev || n_ev < 1) return 7;
  printf("records=%ld treads=%ld counters=%ld span_events=%ld "
         "fed_before_median=%ld median_patched=%ld\n", (long)total, (long)nt,
         (long)n_ctr, (long)n_ev, (long)ctr[10], (long)ctr[11]);
  sio_ex_destroy(e);
  sio_close(h);
  // multithreaded batched Huber under the same sanitizer
  const int64_t L = 4000, S = 64;
  std::vector<double> X(L * S), mu(L), sd(L);
  std::vector<uint8_t> mth(L);
  unsigned seed = 7;
  for (auto& v : X) v = (double)(rand_r(&seed) % 1000) / 100.0;
  sio_hubers_batch(X.data(), L, S, 1.5, 1e-8, 1000, 0.7784, mu.data(),
                   sd.data(), mth.data());
  printf("huber ok\n");
  return 0;
}
CCEOF

echo "[sanitize] fuzz corpus (truncations + bit flips)" >&2
python - "$CRAM" "$TMP/corpus" <<'PY'
import random, os, sys
cram, out = sys.argv[1], sys.argv[2]
os.makedirs(out, exist_ok=True)
blob = bytearray(open(cram, "rb").read())
rng = random.Random(77)
i = 0
for frac in (0.05, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99):
    open(f"{out}/c{i:03d}.cram", "wb").write(bytes(blob[:int(len(blob)*frac)])); i += 1
for _ in range(40):
    m = bytearray(blob)
    for _ in range(rng.randrange(1, 10)):
        k = rng.randrange(30, len(m)); m[k] ^= 1 << rng.randrange(8)
    open(f"{out}/c{i:03d}.cram", "wb").write(bytes(m)); i += 1
print(i)
PY

echo "[sanitize] codec blobs (arith / fqzcomp / tok3)" >&2
python - "$TMP" <<'PY'
import random, sys
sys.path.insert(0, ".")
from strling_tpu_torch.io.cramwrite import arith_encode, fqz_encode, tok3_encode
rng = random.Random(3)
data = bytes(rng.choice(b"ACGTN") for _ in range(4000))
recs = [bytes(rng.randrange(33, 73) for _ in range(rng.randrange(60, 152)))
        for _ in range(30)]
names = b"".join(f"rd:{i:05d}:x\x00".encode() for i in range(300))
from strling_tpu_torch.io.cramwrite import fqz_encode31
sels = [rng.randrange(0, 3) for _ in recs]
rev = [bool(rng.randrange(2)) for _ in recs]
f31 = fqz_encode31(
    recs,
    [dict(do_sel=True, sloc=14, qtab=[min(i, 31) for i in range(256)]),
     dict(qbits=4, qshift=2, ptab=[min(i // 32, 15) for i in range(1024)])],
    selectors=sels, stab=[0, 0, 1] + [1] * 253, reverse=rev)
blobs = {
    "arith": (arith_encode(data, order=1, rle=True), len(data)),
    "fqz": (fqz_encode(recs), sum(map(len, recs))),
    "fqz31": (f31, sum(map(len, recs))),
    "tok3": (tok3_encode(names, use_arith=True), len(names)),
}
out = sys.argv[1]
for k, (b, u) in blobs.items():
    open(f"{out}/{k}.blob", "wb").write(b)
    open(f"{out}/{k}.usize", "w").write(str(u))
PY

# the engine's sources compiled once per build and sanitizer, in parallel
objects() {  # build san -> object directory
  local build=$1 san=$2 out="$TMP/obj-$1-$2" inc=() srcs=("$SRC"/*.cc) pids=()
  if [ "$build" = compat ]; then
    inc=(-I "$COMPAT/libdeflate" -I "$COMPAT/lzma")
    srcs+=("$COMPAT/libdeflate_zlib.cc")
  fi
  mkdir -p "$out"
  for f in "${srcs[@]}"; do
    g++ -fsanitize="$san" "${FLAGS[@]}" "${inc[@]}" -fPIC -c "$f" \
        -o "$out/$(basename "$f" .cc).o" &
    pids+=($!)
  done
  for p in "${pids[@]}"; do wait "$p"; done
  echo "$out"
}

link() {  # build san main -> binary
  local build=$1 san=$2 main=$3 libs
  if [ "$build" = compat ]; then libs=(-lz "$LZMALIB" "$BZ2LIB")
  else libs=(-ldeflate -lz -llzma "$BZ2LIB"); fi
  g++ -fsanitize="$san" "${FLAGS[@]}" "$TMP/$main.cc" "$TMP/obj-$build-$san"/*.o \
      -o "$TMP/$build-$main-${san%%,*}" "${libs[@]}"
  echo "$TMP/$build-$main-${san%%,*}"
}

for build in $BUILDS; do
  case $build in system|compat) ;; *) echo "unknown build $build" >&2; exit 2;; esac
  echo "[sanitize] $build: TSAN and ASAN+UBSAN builds" >&2
  objects "$build" thread > /dev/null
  objects "$build" address,undefined > /dev/null
  tsan_scan=$(link "$build" thread scan)
  tsan_engine=$(link "$build" thread engine)
  asan_scan=$(link "$build" address,undefined scan)
  asan_codec=$(link "$build" address,undefined codec)
  asan_engine=$(link "$build" address,undefined engine)

  echo "[sanitize] $build TSAN: BAM scan (BgzfMT)" >&2
  "$tsan_scan" "$BAM" 2> "$TMP/$build-tsan1.log"
  echo "[sanitize] $build TSAN: CRAM scan x3 (parallel container decode)" >&2
  for i in 1 2 3; do "$tsan_scan" "$CRAM" "$FASTA" 2>> "$TMP/$build-tsan2.log"; done
  if grep -q "WARNING: ThreadSanitizer" "$TMP/$build"-tsan*.log; then
    echo "[sanitize] $build TSAN FAILURES:" >&2
    cat "$TMP/$build"-tsan*.log >&2
    exit 1
  fi

  echo "[sanitize] $build ASAN+UBSAN: fuzz corpus" >&2
  bad=0
  for f in "$TMP"/corpus/c*.cram; do
    set +e
    ASAN_OPTIONS=abort_on_error=1 UBSAN_OPTIONS=halt_on_error=1 \
      timeout 30 "$asan_scan" "$f" "$FASTA" > /dev/null 2> "$TMP/asan.log"
    rc=$?
    set -e
    if [ $rc -ge 128 ] || grep -q "ERROR: AddressSanitizer\|runtime error" "$TMP/asan.log"; then
      bad=$((bad+1)); echo "[sanitize] $build ASAN/UBSAN failure on $f:" >&2
      head -30 "$TMP/asan.log" >&2
    fi
  done
  [ "$bad" -eq 0 ] || exit 1
  ASAN_OPTIONS=abort_on_error=1 "$asan_scan" "$CRAM" "$FASTA" > /dev/null
  ASAN_OPTIONS=abort_on_error=1 "$asan_scan" "$BAM" > /dev/null

  echo "[sanitize] $build ASAN+UBSAN: codec blob fuzz (arith / fqzcomp / tok3)" >&2
  for mode in arith fqz fqz31 tok3; do
    ASAN_OPTIONS=abort_on_error=1 UBSAN_OPTIONS=halt_on_error=1 \
      timeout 120 "$asan_codec" "$mode" "$TMP/$mode.blob" \
      "$(cat "$TMP/$mode.usize")" > /dev/null
  done

  echo "[sanitize] $build TSAN: extract engine producer thread (pipelined fused reader)" >&2
  timeout 300 "$tsan_engine" "$BAM" > "$TMP/engine.out" 2> "$TMP/$build-tsan3.log"
  grep -q "^records=.* median_patched=[1-9]" "$TMP/engine.out"
  ASAN_OPTIONS=abort_on_error=1 UBSAN_OPTIONS=halt_on_error=1 \
    timeout 300 "$asan_engine" "$BAM" > /dev/null
  if grep -q "WARNING: ThreadSanitizer" "$TMP/$build-tsan3.log"; then
    echo "[sanitize] $build TSAN FAILURES (engine):" >&2
    cat "$TMP/$build-tsan3.log" >&2
    exit 1
  fi
  echo "[sanitize] $build OK: TSAN clean (scan + engine producer), ASAN+UBSAN clean over corpus + codec blobs" >&2
done
echo "[sanitize] OK: $BUILDS" >&2

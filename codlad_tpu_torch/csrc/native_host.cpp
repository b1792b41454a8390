// Host helpers of codlad_tpu_torch (built by codlad_tpu_torch/native.py with
// `g++ -O3 -shared -fPIC` into codlad_tpu_torch/_build/ at first use).
// A copy of native/codlad_native.cpp, the JAX package's helpers, so that the
// port builds and loads its own library.
//
// 1. lap_solve: exact linear assignment (shortest augmenting path, the
//    Jonker-Volgenant-style O(n^3) algorithm) -- the exact minibatch OT
//    coupling for flow matching (gen/ot.py `exact_assignment`). The
//    reference delegates this to POT's compiled EMD solver (reference:
//    diffusion_and_flow/optimal_transport.py:44-94).
// 2. radius_graph: cell-list neighbor search, O(N) instead of the
//    reference's dense O(N^2) distance matrix (reference:
//    utils/protein_module.py:567-584) -- the featurizer's hot loop.
// 3. xtc_decode / xtc_encode: the XTC (XDR 3dfcoord) codec of data/xtc.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Exact LAP via shortest augmenting paths with dual potentials.
// cost: n x n row-major. Writes col_of_row[n]. Returns 0 on success.
int lap_solve(const double* cost, int n, int32_t* col_of_row) {
  const double INF = std::numeric_limits<double>::infinity();
  // potentials; row 0 / col 0 are virtual (1-indexed internally)
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0);    // p[j] = row matched to column j
  std::vector<int> way(n + 1, 0);  // predecessor columns on the path

  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 < 0) return 1;  // infeasible (should not happen for finite costs)
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    // augment along the path
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int j = 1; j <= n; ++j) {
    if (p[j] > 0) col_of_row[p[j] - 1] = j - 1;
  }
  return 0;
}

// Cell-list radius graph. xyz: [n, 3] doubles; valid: [n] uint8.
// Emits undirected pairs (i < j) into out_pairs (capacity `cap` pairs).
// Returns the number of pairs found (may exceed cap — caller must check
// and retry with a larger buffer; only `cap` pairs are written).
int64_t radius_graph(const double* xyz, const uint8_t* valid, int64_t n,
                     double cutoff, int32_t* out_pairs, int64_t cap) {
  if (n == 0) return 0;
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  int64_t n_valid = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    ++n_valid;
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], xyz[i * 3 + d]);
      hi[d] = std::max(hi[d], xyz[i * 3 + d]);
    }
  }
  if (n_valid == 0) return 0;

  const double cell = cutoff;
  int64_t dims[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = std::max<int64_t>(1, (int64_t)((hi[d] - lo[d]) / cell) + 1);
    dims[d] = std::min<int64_t>(dims[d], 512);  // bound memory for outliers
  }
  const int64_t ncells = dims[0] * dims[1] * dims[2];

  auto cell_of = [&](int64_t i, int64_t c[3]) {
    for (int d = 0; d < 3; ++d) {
      int64_t k = (int64_t)((xyz[i * 3 + d] - lo[d]) / cell);
      c[d] = std::min(std::max<int64_t>(k, 0), dims[d] - 1);
    }
  };

  // counting sort of atoms into cells
  std::vector<int64_t> head(ncells, -1), next(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    int64_t c[3];
    cell_of(i, c);
    int64_t ci = (c[0] * dims[1] + c[1]) * dims[2] + c[2];
    next[i] = head[ci];
    head[ci] = i;
  }

  const double cut2 = cutoff * cutoff;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    int64_t c[3];
    cell_of(i, c);
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          int64_t cx = c[0] + dx, cy = c[1] + dy, cz = c[2] + dz;
          if (cx < 0 || cy < 0 || cz < 0 || cx >= dims[0] || cy >= dims[1] ||
              cz >= dims[2])
            continue;
          for (int64_t j = head[(cx * dims[1] + cy) * dims[2] + cz]; j >= 0;
               j = next[j]) {
            if (j <= i) continue;
            double dx0 = xyz[i * 3] - xyz[j * 3];
            double dy0 = xyz[i * 3 + 1] - xyz[j * 3 + 1];
            double dz0 = xyz[i * 3 + 2] - xyz[j * 3 + 2];
            if (dx0 * dx0 + dy0 * dy0 + dz0 * dz0 <= cut2) {
              if (count < cap) {
                out_pairs[count * 2] = (int32_t)i;
                out_pairs[count * 2 + 1] = (int32_t)j;
              }
              ++count;
            }
          }
        }
  }
  return count;
}


// ---------------------------------------------------------------------------
// 3. XTC (XDR 3dfcoord) codec — GROMACS trajectory compression.
//    The reference reads Atlas xtc trios through mdtraj's compiled xdrfile
//    (reference: utils/protein_module.py:898, utils/dataset_module.py:
//    148-160); here the public-domain xdrfile algorithm is reimplemented
//    so trajectory ingestion needs no third-party C library.  The decoder
//    covers the full format (run-length water packing, adaptive smallidx);
//    the encoder mirrors the adaptive GROMACS writer so fixtures exercise
//    every decoder branch.
// ---------------------------------------------------------------------------

static const int kMagicInts[] = {
    0,       0,       0,       0,       0,        0,        0,        0,
    0,       8,       10,      12,      16,       20,       25,       32,
    40,      50,      64,      80,      101,      128,      161,      203,
    256,     322,     406,     512,     645,      812,      1024,     1290,
    1625,    2048,    2580,    3250,    4096,     5060,     6501,     8192,
    10321,   13003,   16384,   20642,   26007,    32768,    41285,    52015,
    65536,   82570,   104031,  131072,  165140,   208063,   262144,   330280,
    416127,  524287,  660561,  832255,  1048576,  1321122,  1664510,  2097152,
    2642245, 3329021, 4194304, 5284491, 6658042,  8388607,  10568983, 13316085,
    16777216};
static const int kFirstIdx = 9;
static const int kLastIdx = (int)(sizeof(kMagicInts) / sizeof(int)) - 1;

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t nbytes;
  int64_t cnt = 0;
  uint32_t lastbits = 0;
  uint64_t lastbyte = 0;
  bool overrun = false;

  uint8_t next_byte() {
    if (cnt >= nbytes) {
      overrun = true;
      return 0;
    }
    return data[cnt++];
  }

  uint32_t bits(int nbits) {
    uint64_t num = 0;
    uint32_t mask = (nbits >= 32) ? 0xffffffffu : ((1u << nbits) - 1);
    while (nbits >= 8) {
      lastbyte = (lastbyte << 8) | next_byte();
      num |= (lastbyte >> lastbits) << (nbits - 8);
      nbits -= 8;
    }
    if (nbits > 0) {
      if ((int)lastbits < nbits) {
        lastbits += 8;
        lastbyte = (lastbyte << 8) | next_byte();
      }
      lastbits -= nbits;
      num |= (lastbyte >> lastbits) & ((1u << nbits) - 1);
    }
    return (uint32_t)num & mask;
  }

  // Read num_of_bits as a base-256 little-endian big number, then peel off
  // nums[2], nums[1] by division with sizes; nums[0] is the remainder.
  void ints(int num_of_bits, const uint32_t sizes[3], int32_t nums[3]) {
    uint32_t bytes[32];
    int num_of_bytes = 0;
    bytes[1] = bytes[2] = bytes[3] = 0;
    while (num_of_bits > 8) {
      bytes[num_of_bytes++] = bits(8);
      num_of_bits -= 8;
    }
    if (num_of_bits > 0) bytes[num_of_bytes++] = bits(num_of_bits);
    for (int i = 2; i > 0; i--) {
      uint64_t num = 0;
      for (int j = num_of_bytes - 1; j >= 0; j--) {
        num = (num << 8) | bytes[j];
        uint64_t p = num / sizes[i];
        bytes[j] = (uint32_t)p;
        num = num - p * sizes[i];
      }
      nums[i] = (int32_t)num;
    }
    nums[0] = (int32_t)(bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) |
                        (bytes[3] << 24));
  }
};

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t cnt = 0;
  uint32_t lastbits = 0;
  uint64_t lastbyte = 0;
  bool overrun = false;

  void put_byte(uint8_t b) {
    if (cnt >= cap) {
      overrun = true;
      return;
    }
    out[cnt++] = b;
  }

  void bits(int nbits, uint32_t num) {
    while (nbits >= 8) {
      lastbyte = (lastbyte << 8) | ((num >> (nbits - 8)) & 0xff);
      put_byte((uint8_t)(lastbyte >> lastbits));
      nbits -= 8;
    }
    if (nbits > 0) {
      lastbyte = (lastbyte << nbits) | (num & ((1u << nbits) - 1));
      lastbits += nbits;
      if (lastbits >= 8) {
        lastbits -= 8;
        put_byte((uint8_t)(lastbyte >> lastbits));
      }
    }
  }

  void flush() {
    if (lastbits > 0) {
      put_byte((uint8_t)(lastbyte << (8 - lastbits)));
      lastbits = 0;
    }
  }

  void ints(int num_of_bits, const uint32_t sizes[3], const int32_t nums[3]) {
    uint32_t bytes[32];
    uint64_t tmp = (uint32_t)nums[0];
    int num_of_bytes = 0;
    do {
      bytes[num_of_bytes++] = tmp & 0xff;
      tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < 3; i++) {
      tmp = (uint32_t)nums[i];
      int bytecnt;
      for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
        tmp += (uint64_t)bytes[bytecnt] * sizes[i];
        bytes[bytecnt] = tmp & 0xff;
        tmp >>= 8;
      }
      while (tmp != 0) {
        bytes[bytecnt++] = tmp & 0xff;
        tmp >>= 8;
      }
      num_of_bytes = bytecnt;
    }
    if (num_of_bits >= num_of_bytes * 8) {
      for (int i = 0; i < num_of_bytes; i++) bits(8, bytes[i]);
      bits(num_of_bits - num_of_bytes * 8, 0);
    } else {
      int i;
      for (i = 0; i < num_of_bytes - 1; i++) bits(8, bytes[i]);
      bits(num_of_bits - (num_of_bytes - 1) * 8, bytes[i]);
    }
  }
};

static int sizeof_int(uint32_t size) {
  uint64_t num = 1;
  int nbits = 0;
  while (size >= num && nbits < 32) {
    nbits++;
    num <<= 1;
  }
  return nbits;
}

static int sizeof_ints(const uint32_t sizes[3]) {
  uint32_t bytes[32];
  bytes[0] = 1;
  uint32_t num_of_bytes = 1;
  for (int i = 0; i < 3; i++) {
    uint64_t tmp = 0;
    uint32_t bytecnt;
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
      tmp += (uint64_t)bytes[bytecnt] * sizes[i];
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    num_of_bytes = bytecnt;
  }
  int num = 1, nbits = 0;
  num_of_bytes--;
  while (bytes[num_of_bytes] >= (uint32_t)num) {
    nbits++;
    num *= 2;
  }
  return nbits + num_of_bytes * 8;
}

}  // namespace

// Decode one compressed xdr3dfcoord payload (the byte blob after the
// smallidx field).  out: natoms*3 floats.  Returns 0 ok, <0 error.
int xtc_decode(const uint8_t* data, int64_t nbytes, int32_t natoms,
               const int32_t* minint, const int32_t* maxint, int32_t smallidx,
               float precision, float* out) {
  if (natoms <= 0 || smallidx < kFirstIdx || smallidx >= kLastIdx) return -1;
  uint32_t sizeint[3], sizesmall[3];
  int bitsizeint[3] = {0, 0, 0};
  int bitsize;
  for (int d = 0; d < 3; d++) {
    int64_t s = (int64_t)maxint[d] - minint[d] + 1;
    if (s <= 0 || s > (int64_t)1 << 31) return -2;
    sizeint[d] = (uint32_t)s;
  }
  if (sizeint[0] > 0xffffff || sizeint[1] > 0xffffff ||
      sizeint[2] > 0xffffff) {
    for (int d = 0; d < 3; d++) bitsizeint[d] = sizeof_int(sizeint[d]);
    bitsize = 0;
  } else {
    bitsize = sizeof_ints(sizeint);
  }
  int smallnum = kMagicInts[smallidx] / 2;
  sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)kMagicInts[smallidx];
  int smaller =
      kMagicInts[smallidx - 1 > kFirstIdx ? smallidx - 1 : kFirstIdx] / 2;
  float inv_precision = 1.0f / precision;

  BitReader br{data, nbytes};
  int32_t thiscoord[3], prevcoord[3] = {0, 0, 0};
  int run = 0;
  int64_t i = 0, emitted = 0;
  while (i < natoms) {
    if (bitsize == 0) {
      for (int d = 0; d < 3; d++)
        thiscoord[d] = (int32_t)br.bits(bitsizeint[d]);
    } else {
      br.ints(bitsize, sizeint, thiscoord);
    }
    i++;
    for (int d = 0; d < 3; d++) {
      thiscoord[d] += minint[d];
      prevcoord[d] = thiscoord[d];
    }
    int flag = (int)br.bits(1);
    int is_smaller = 0;
    if (flag == 1) {
      run = (int)br.bits(5);
      is_smaller = run % 3;
      run -= is_smaller;
      is_smaller--;
    }
    if (emitted + 1 + run / 3 > natoms) return -3;
    if (run > 0) {
      for (int k = 0; k < run; k += 3) {
        br.ints(smallidx, sizesmall, thiscoord);
        i++;
        for (int d = 0; d < 3; d++) thiscoord[d] += prevcoord[d] - smallnum;
        if (k == 0) {
          // large atom was swapped behind its small neighbor at encode time
          for (int d = 0; d < 3; d++) {
            int32_t tmp = thiscoord[d];
            thiscoord[d] = prevcoord[d];
            prevcoord[d] = tmp;
          }
          for (int d = 0; d < 3; d++)
            out[emitted * 3 + d] = prevcoord[d] * inv_precision;
          emitted++;
        } else {
          for (int d = 0; d < 3; d++) prevcoord[d] = thiscoord[d];
        }
        for (int d = 0; d < 3; d++)
          out[emitted * 3 + d] = thiscoord[d] * inv_precision;
        emitted++;
      }
    } else {
      for (int d = 0; d < 3; d++)
        out[emitted * 3 + d] = thiscoord[d] * inv_precision;
      emitted++;
    }
    smallidx += is_smaller;
    if (is_smaller < 0) {
      smallnum = smaller;
      smaller = (smallidx > kFirstIdx) ? kMagicInts[smallidx - 1] / 2 : 0;
    } else if (is_smaller > 0) {
      smaller = smallnum;
      smallnum = kMagicInts[smallidx] / 2;
    }
    if (smallidx < kFirstIdx || smallidx >= kLastIdx) return -4;
    sizesmall[0] = sizesmall[1] = sizesmall[2] =
        (uint32_t)kMagicInts[smallidx];
    if (sizesmall[0] == 0) return -5;
    if (br.overrun) return -6;
  }
  return emitted == natoms ? 0 : -7;
}

// Encode natoms*3 floats with the adaptive GROMACS heuristics (run-length
// packing of consecutive close atoms, smallidx adaptation).  Returns bytes
// written, or <0 (overflow / cap too small).
int64_t xtc_encode(const float* xyz, int32_t natoms, float precision,
                   uint8_t* out, int64_t cap, int32_t* minint_out,
                   int32_t* maxint_out, int32_t* smallidx_out) {
  if (natoms <= 0) return -1;
  std::vector<int32_t> ip((size_t)natoms * 3);
  int32_t minint[3], maxint[3];
  for (int d = 0; d < 3; d++) {
    minint[d] = INT32_MAX;
    maxint[d] = INT32_MIN;
  }
  int64_t mindiff = INT64_MAX;
  int32_t oldl[3] = {0, 0, 0};
  const double kMaxAbs = (double)(INT32_MAX - 2);
  for (int64_t a = 0; a < natoms; a++) {
    int32_t l[3];
    for (int d = 0; d < 3; d++) {
      double lf = (double)xyz[a * 3 + d] * precision;
      lf += (lf >= 0.0) ? 0.5 : -0.5;
      if (lf > kMaxAbs || lf < -kMaxAbs) return -2;
      l[d] = (int32_t)lf;
      if (l[d] < minint[d]) minint[d] = l[d];
      if (l[d] > maxint[d]) maxint[d] = l[d];
      ip[a * 3 + d] = l[d];
    }
    int64_t diff = 0;
    for (int d = 0; d < 3; d++)
      diff += l[d] > oldl[d] ? l[d] - oldl[d] : oldl[d] - l[d];
    if (a >= 1 && diff < mindiff) mindiff = diff;
    for (int d = 0; d < 3; d++) oldl[d] = l[d];
  }
  for (int d = 0; d < 3; d++) {
    minint_out[d] = minint[d];
    maxint_out[d] = maxint[d];
  }

  uint32_t sizeint[3], sizesmall[3];
  int bitsizeint[3] = {0, 0, 0};
  int bitsize;
  for (int d = 0; d < 3; d++)
    sizeint[d] = (uint32_t)((int64_t)maxint[d] - minint[d] + 1);
  if (sizeint[0] > 0xffffff || sizeint[1] > 0xffffff ||
      sizeint[2] > 0xffffff) {
    for (int d = 0; d < 3; d++) bitsizeint[d] = sizeof_int(sizeint[d]);
    bitsize = 0;
  } else {
    bitsize = sizeof_ints(sizeint);
  }

  int smallidx = kFirstIdx;
  while (smallidx < kLastIdx - 1 && kMagicInts[smallidx] < mindiff) smallidx++;
  *smallidx_out = smallidx;
  int maxidx = smallidx + 8 < kLastIdx ? smallidx + 8 : kLastIdx;
  int minidx = maxidx - 8;
  int larger = kMagicInts[maxidx] / 2;
  int smaller =
      kMagicInts[smallidx - 1 > kFirstIdx ? smallidx - 1 : kFirstIdx] / 2;
  int smallnum = kMagicInts[smallidx] / 2;
  sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)kMagicInts[smallidx];

  BitWriter bw{out, cap};
  int prevrun = -1;
  int32_t prevcoord[3] = {0, 0, 0};
  int32_t tmpcoord[30];
  int64_t i = 0;
  while (i < natoms) {
    int32_t* thiscoord = &ip[(size_t)i * 3];
    int is_small = 0;
    int is_smaller;
    if (smallidx < maxidx && i >= 1 &&
        std::abs(thiscoord[0] - prevcoord[0]) < larger &&
        std::abs(thiscoord[1] - prevcoord[1]) < larger &&
        std::abs(thiscoord[2] - prevcoord[2]) < larger) {
      is_smaller = 1;
    } else if (smallidx > minidx) {
      is_smaller = -1;
    } else {
      is_smaller = 0;
    }
    if (i + 1 < natoms &&
        std::abs(thiscoord[0] - thiscoord[3]) < smallnum &&
        std::abs(thiscoord[1] - thiscoord[4]) < smallnum &&
        std::abs(thiscoord[2] - thiscoord[5]) < smallnum) {
      for (int d = 0; d < 3; d++) {
        int32_t tmp = thiscoord[d];
        thiscoord[d] = thiscoord[d + 3];
        thiscoord[d + 3] = tmp;
      }
      is_small = 1;
    }
    int32_t tc[3];
    for (int d = 0; d < 3; d++) tc[d] = thiscoord[d] - minint[d];
    if (bitsize == 0) {
      for (int d = 0; d < 3; d++) bw.bits(bitsizeint[d], (uint32_t)tc[d]);
    } else {
      bw.ints(bitsize, sizeint, tc);
    }
    for (int d = 0; d < 3; d++) prevcoord[d] = thiscoord[d];
    i++;
    thiscoord += 3;

    int run = 0;
    if (is_small == 0 && is_smaller == -1) is_smaller = 0;
    while (is_small && run < 8 * 3) {
      if (is_smaller == -1) {
        int64_t s2 = 0;
        for (int d = 0; d < 3; d++) {
          int64_t dd = (int64_t)thiscoord[d] - prevcoord[d];
          s2 += dd * dd;
        }
        if (s2 >= (int64_t)smaller * smaller) is_smaller = 0;
      }
      for (int d = 0; d < 3; d++)
        tmpcoord[run++] = thiscoord[d] - prevcoord[d] + smallnum;
      for (int d = 0; d < 3; d++) prevcoord[d] = thiscoord[d];
      i++;
      thiscoord += 3;
      is_small = 0;
      if (i < natoms && std::abs(thiscoord[0] - prevcoord[0]) < smallnum &&
          std::abs(thiscoord[1] - prevcoord[1]) < smallnum &&
          std::abs(thiscoord[2] - prevcoord[2]) < smallnum) {
        is_small = 1;
      }
    }
    if (run != prevrun || is_smaller != 0) {
      prevrun = run;
      bw.bits(1, 1);
      bw.bits(5, (uint32_t)(run + is_smaller + 1));
    } else {
      bw.bits(1, 0);
    }
    for (int k = 0; k < run; k += 3) bw.ints(smallidx, sizesmall, &tmpcoord[k]);
    if (is_smaller != 0) {
      smallidx += is_smaller;
      if (is_smaller < 0) {
        smallnum = smaller;
        smaller = (smallidx > kFirstIdx) ? kMagicInts[smallidx - 1] / 2 : 0;
      } else {
        smaller = smallnum;
        smallnum = kMagicInts[smallidx] / 2;
      }
      sizesmall[0] = sizesmall[1] = sizesmall[2] =
          (uint32_t)kMagicInts[smallidx];
    }
    if (bw.overrun) return -3;
  }
  bw.flush();
  if (bw.overrun) return -3;
  return bw.cnt;
}

}  // extern "C"

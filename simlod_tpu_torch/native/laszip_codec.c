/* LASzip-compatible LAZ codec (decoder + encoder) for point formats 0-3.
 *
 * Implemented from the published LAZ specification ("LAZ Specification 1.4"
 * / Isenburg, "LASzip: lossless compression of LiDAR data", PE&RS 2013):
 * FastAC-style arithmetic coder, adaptive symbol/bit models, the
 * IntegerCompressor, and the v2 item codecs POINT10 / GPSTIME11 / RGB12 /
 * BYTE with chunked framing (compressor id 2).
 *
 * Reference capability being matched: the vendored laszip decode path at
 * main_progressive_octree.cpp:879-926 (~30 MP/s LAZ ingest). This file is an
 * independent C implementation, not a copy of the laszip library.
 *
 * Build: cc -O2 -shared -fPIC -o _laszip.so laszip_codec.c
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;
typedef int16_t I16;
typedef int32_t I32;
typedef int64_t I64;

#define AC_MIN_LENGTH 0x01000000u
#define AC_MAX_LENGTH 0xFFFFFFFFu
#define BM_LENGTH_SHIFT 13
#define BM_MAX_COUNT (1u << BM_LENGTH_SHIFT)
#define DM_LENGTH_SHIFT 15
#define DM_MAX_COUNT (1u << DM_LENGTH_SHIFT)

/* ------------------------------------------------------------------ */
/* adaptive models                                                     */
/* ------------------------------------------------------------------ */

typedef struct {
  U32 symbols, last_symbol;
  U32 total_count, update_cycle, symbols_until_update;
  U32 *distribution; /* [symbols] cumulative, DM_LENGTH_SHIFT scaled */
  U32 *symbol_count; /* [symbols] */
  /* decoder acceleration: bucket table over the scaled cumulative space.
   * For >16-symbol models the symbol search starts from
   * lookup[dv >> lookup_shift] instead of 0..symbols (the binary search over
   * 256-entry models was 74% of decode time under gprof). */
  U32 *lookup;       /* [lookup_size + 2] or NULL */
  U32 lookup_size, lookup_shift;
} Model;

typedef struct {
  U32 bit_0_prob, bit_0_count, bit_count;
  U32 update_cycle, bits_until_update;
} BitModel;

static void model_update(Model *m) {
  if ((m->total_count += m->update_cycle) > DM_MAX_COUNT) {
    m->total_count = 0;
    for (U32 k = 0; k < m->symbols; k++)
      m->total_count += (m->symbol_count[k] = (m->symbol_count[k] + 1) >> 1);
  }
  U32 sum = 0, scale = 0x80000000u / m->total_count;
  if (m->lookup) {
    U32 s = 0;
    for (U32 k = 0; k < m->symbols; k++) {
      m->distribution[k] = (scale * sum) >> (31 - DM_LENGTH_SHIFT);
      sum += m->symbol_count[k];
      U32 w = m->distribution[k] >> m->lookup_shift;
      while (s < w) m->lookup[++s] = k - 1;
    }
    m->lookup[0] = 0;
    while (s <= m->lookup_size) m->lookup[++s] = m->symbols - 1;
  } else {
    for (U32 k = 0; k < m->symbols; k++) {
      m->distribution[k] = (scale * sum) >> (31 - DM_LENGTH_SHIFT);
      sum += m->symbol_count[k];
    }
  }
  U32 max_cycle = (m->symbols + 6) << 3;
  m->update_cycle = (5 * m->update_cycle) >> 2;
  if (m->update_cycle > max_cycle) m->update_cycle = max_cycle;
  m->symbols_until_update = m->update_cycle;
}

static void model_init(Model *m, U32 symbols) {
  if (!m->distribution) {
    m->distribution = (U32 *)malloc(symbols * sizeof(U32));
    m->symbol_count = (U32 *)malloc(symbols * sizeof(U32));
    if (symbols > 16) {
      U32 table_bits = 3;
      while (symbols > (1u << (table_bits + 2))) ++table_bits;
      m->lookup_size = 1u << table_bits;
      m->lookup_shift = DM_LENGTH_SHIFT - table_bits;
      m->lookup = (U32 *)malloc((m->lookup_size + 2) * sizeof(U32));
    } else {
      m->lookup = 0;
      m->lookup_size = 0;
      m->lookup_shift = 0;
    }
  }
  m->symbols = symbols;
  m->last_symbol = symbols - 1;
  m->total_count = 0;
  m->update_cycle = symbols;
  for (U32 k = 0; k < symbols; k++) m->symbol_count[k] = 1;
  model_update(m);
  m->symbols_until_update = m->update_cycle = (symbols + 6) >> 1;
}

static void model_free(Model *m) {
  free(m->distribution);
  free(m->symbol_count);
  free(m->lookup);
  m->distribution = 0;
  m->symbol_count = 0;
  m->lookup = 0;
}

static void bitmodel_init(BitModel *m) {
  m->bit_0_count = 1;
  m->bit_count = 2;
  m->bit_0_prob = 1u << (BM_LENGTH_SHIFT - 1);
  m->update_cycle = m->bits_until_update = 4;
}

static void bitmodel_update(BitModel *m) {
  if ((m->bit_count += m->update_cycle) > BM_MAX_COUNT) {
    m->bit_count = (m->bit_count + 1) >> 1;
    m->bit_0_count = (m->bit_0_count + 1) >> 1;
    if (m->bit_0_count == m->bit_count) ++m->bit_count;
  }
  m->bit_0_prob = (m->bit_0_count << BM_LENGTH_SHIFT) / m->bit_count;
  m->update_cycle = (5 * m->update_cycle) >> 2;
  if (m->update_cycle > 64) m->update_cycle = 64;
  m->bits_until_update = m->update_cycle;
}

/* ------------------------------------------------------------------ */
/* arithmetic decoder                                                  */
/* ------------------------------------------------------------------ */

typedef struct {
  const U8 *in, *end;
  U32 value, length;
} Dec;

static U8 dec_byte(Dec *d) { return d->in < d->end ? *d->in++ : 0; }

static void dec_init(Dec *d, const U8 *in, const U8 *end) {
  d->in = in;
  d->end = end;
  d->value = ((U32)dec_byte(d) << 24) | ((U32)dec_byte(d) << 16) |
             ((U32)dec_byte(d) << 8) | dec_byte(d);
  d->length = AC_MAX_LENGTH;
}

static void dec_renorm(Dec *d) {
  do {
    d->value = (d->value << 8) | dec_byte(d);
  } while ((d->length <<= 8) < AC_MIN_LENGTH);
}

static U32 dec_bit(Dec *d, BitModel *m) {
  U32 x = m->bit_0_prob * (d->length >> BM_LENGTH_SHIFT);
  U32 sym = (d->value >= x);
  if (sym) {
    d->value -= x;
    d->length -= x;
  } else {
    d->length = x;
    ++m->bit_0_count;
  }
  if (d->length < AC_MIN_LENGTH) dec_renorm(d);
  if (--m->bits_until_update == 0) bitmodel_update(m);
  return sym;
}

static U32 dec_symbol(Dec *d, Model *m) {
  U32 x, sym, n, y = d->length;
  d->length >>= DM_LENGTH_SHIFT;
  U32 dv = d->value / d->length;
  /* bucket-table start, then a short search: largest sym with
   * distribution[sym] <= dv */
  if (m->lookup) {
    U32 t = dv >> m->lookup_shift;
    sym = m->lookup[t];
    n = m->lookup[t + 1] + 1;
  } else {
    sym = 0;
    n = m->symbols;
  }
  while (n > sym + 1) {
    U32 k = (sym + n) >> 1;
    if (m->distribution[k] > dv) n = k;
    else sym = k;
  }
  x = m->distribution[sym] * d->length;
  if (sym != m->last_symbol) y = m->distribution[sym + 1] * d->length;
  d->value -= x;
  d->length = y - x;
  if (d->length < AC_MIN_LENGTH) dec_renorm(d);
  ++m->symbol_count[sym];
  if (--m->symbols_until_update == 0) model_update(m);
  return sym;
}

static U32 dec_raw_bits(Dec *d, U32 bits) {
  if (bits > 19) {
    U32 lo = dec_raw_bits(d, 16);
    U32 hi = dec_raw_bits(d, bits - 16) << 16;
    return hi | lo;
  }
  U32 sym = d->value / (d->length >>= bits);
  d->value -= d->length * sym;
  if (d->length < AC_MIN_LENGTH) dec_renorm(d);
  return sym;
}

/* ------------------------------------------------------------------ */
/* arithmetic encoder                                                  */
/* ------------------------------------------------------------------ */

typedef struct {
  U8 *out, *start, *end;
  U32 base, length;
  int overflow;
} Enc;

static void enc_init(Enc *e, U8 *out, U8 *end) {
  e->out = e->start = out;
  e->end = end;
  e->base = 0;
  e->length = AC_MAX_LENGTH;
  e->overflow = 0;
}

static void enc_put(Enc *e, U8 b) {
  if (e->out < e->end) *e->out++ = b;
  else e->overflow = 1;
}

static void enc_carry(Enc *e) {
  U8 *p = e->out - 1;
  while (p >= e->start && *p == 0xFF) *p-- = 0;
  if (p >= e->start) ++*p;
}

static void enc_renorm(Enc *e) {
  do {
    enc_put(e, (U8)(e->base >> 24));
    e->base <<= 8;
  } while ((e->length <<= 8) < AC_MIN_LENGTH);
}

static void enc_bit(Enc *e, BitModel *m, U32 bit) {
  U32 x = m->bit_0_prob * (e->length >> BM_LENGTH_SHIFT);
  if (bit) {
    U32 init_base = e->base;
    e->base += x;
    e->length -= x;
    if (init_base > e->base) enc_carry(e);
  } else {
    e->length = x;
    ++m->bit_0_count;
  }
  if (e->length < AC_MIN_LENGTH) enc_renorm(e);
  if (--m->bits_until_update == 0) bitmodel_update(m);
}

static void enc_symbol(Enc *e, Model *m, U32 sym) {
  U32 x, init_base = e->base;
  if (sym == m->last_symbol) {
    x = m->distribution[sym] * (e->length >> DM_LENGTH_SHIFT);
    e->base += x;
    e->length -= x;
  } else {
    x = m->distribution[sym] * (e->length >>= DM_LENGTH_SHIFT);
    e->base += x;
    e->length = m->distribution[sym + 1] * e->length - x;
  }
  if (init_base > e->base) enc_carry(e);
  if (e->length < AC_MIN_LENGTH) enc_renorm(e);
  ++m->symbol_count[sym];
  if (--m->symbols_until_update == 0) model_update(m);
}

static void enc_raw_bits(Enc *e, U32 bits, U32 sym) {
  if (bits > 19) {
    enc_raw_bits(e, 16, sym & 0xFFFF);
    enc_raw_bits(e, bits - 16, sym >> 16);
    return;
  }
  U32 init_base = e->base;
  e->base += sym * (e->length >>= bits);
  if (init_base > e->base) enc_carry(e);
  if (e->length < AC_MIN_LENGTH) enc_renorm(e);
}

static void enc_done(Enc *e) {
  /* Choose a final base whose trailing bits are irrelevant, then flush so the
   * stream holds EXACTLY (symbol renorm bytes + 4) bytes — the decoder reads
   * 4 bytes at init and one per symbol renorm, so chunk boundaries line up
   * byte-exactly. */
  U32 init_base = e->base;
  int tail;
  if (e->length > 2 * AC_MIN_LENGTH) {
    e->base += AC_MIN_LENGTH;
    e->length = AC_MIN_LENGTH >> 1; /* renorm emits 1 byte */
    tail = 3;
  } else {
    e->base += AC_MIN_LENGTH >> 1;
    e->length = AC_MIN_LENGTH >> 9; /* renorm emits 2 bytes */
    tail = 2;
  }
  if (init_base > e->base) enc_carry(e);
  enc_renorm(e);
  while (tail--) {
    enc_put(e, (U8)(e->base >> 24));
    e->base <<= 8;
  }
}

/* ------------------------------------------------------------------ */
/* integer compressor (bits=32 and bits=16 variants)                   */
/* ------------------------------------------------------------------ */

#define IC_BITS_HIGH 8

typedef struct {
  U32 bits, contexts;
  U32 corr_bits;
  U32 corr_range;
  I32 corr_min;
  U32 k; /* number of bits of the last corrector */
  Model *m_bits;      /* [contexts], corr_bits+1 symbols */
  BitModel m_corr0;
  Model *m_corr;      /* [corr_bits], index k-1 */
} IC;

static void ic_init(IC *ic, U32 bits, U32 contexts) {
  ic->bits = bits;
  ic->contexts = contexts;
  if (bits && bits < 32) {
    ic->corr_bits = bits;
    ic->corr_range = 1u << bits;
    ic->corr_min = -((I32)(ic->corr_range >> 1));
  } else {
    ic->corr_bits = 32;
    ic->corr_range = 0;
    ic->corr_min = (I32)0x80000000;
  }
  ic->k = 0;
  ic->m_bits = (Model *)calloc(contexts, sizeof(Model));
  for (U32 c = 0; c < contexts; c++) model_init(&ic->m_bits[c], ic->corr_bits + 1);
  bitmodel_init(&ic->m_corr0);
  /* payload models for k = 1..corr_bits (a 16-bit IC can emit k == 16) */
  ic->m_corr = (Model *)calloc(ic->corr_bits, sizeof(Model));
  for (U32 k = 1; k <= ic->corr_bits; k++) {
    if (k == 32) break; /* k == 32 carries no payload (corrector == corr_min) */
    model_init(&ic->m_corr[k - 1], k <= IC_BITS_HIGH ? (1u << k) : (1u << IC_BITS_HIGH));
  }
}

static void ic_free(IC *ic) {
  for (U32 c = 0; c < ic->contexts; c++) model_free(&ic->m_bits[c]);
  for (U32 k = 1; k <= ic->corr_bits && k < 32; k++) model_free(&ic->m_corr[k - 1]);
  free(ic->m_bits);
  free(ic->m_corr);
}

static I32 ic_read_corr(IC *ic, Dec *d, Model *m_bits) {
  I32 c;
  U32 k = dec_symbol(d, m_bits);
  ic->k = k;
  if (k) {
    if (k < 32) {
      if (k <= IC_BITS_HIGH) {
        c = (I32)dec_symbol(d, &ic->m_corr[k - 1]);
      } else {
        U32 k1 = k - IC_BITS_HIGH;
        c = (I32)dec_symbol(d, &ic->m_corr[k - 1]);
        U32 c1 = dec_raw_bits(d, k1);
        c = (I32)(((U32)c << k1) | c1);
      }
      if ((U32)c >= (1u << (k - 1))) c += 1;
      else c -= (I32)((1u << k) - 1);
    } else {
      c = ic->corr_min;
    }
  } else {
    c = (I32)dec_bit(d, &ic->m_corr0);
  }
  return c;
}

static I32 ic_decompress(IC *ic, Dec *d, I32 pred, U32 context) {
  I32 real = pred + ic_read_corr(ic, d, &ic->m_bits[context]);
  if (ic->corr_range) { /* bounded-bit wraparound */
    if (real < 0) real += (I32)ic->corr_range;
    else if ((U32)real >= ic->corr_range) real -= (I32)ic->corr_range;
  }
  return real;
}

static void ic_write_corr(IC *ic, Enc *e, I32 c, Model *m_bits) {
  U32 k = 0;
  /* find k: c in [-(2^k - 1), -2^(k-1)] or [2^(k-1)+1, 2^k]; {0,1} -> k=0 */
  if (c == ic->corr_min && ic->corr_bits == 32) {
    k = 32;
  } else if (c > 1) {
    U32 v = (U32)(c - 1);
    while (v >>= 1) k++;
    k += 1;
  } else if (c < 0) {
    U32 v = (U32)(-c);
    k = 0;
    while (v >>= 1) k++;
    k += 1;
  }
  ic->k = k;
  enc_symbol(e, m_bits, k);
  if (k) {
    if (k < 32) {
      U32 raw;
      if (c > 0) raw = (U32)(c - 1);           /* in [2^(k-1), 2^k - 1] */
      else raw = (U32)(c + (I32)((1u << k) - 1)); /* in [0, 2^(k-1) - 1] */
      if (k <= IC_BITS_HIGH) {
        enc_symbol(e, &ic->m_corr[k - 1], raw);
      } else {
        U32 k1 = k - IC_BITS_HIGH;
        enc_symbol(e, &ic->m_corr[k - 1], raw >> k1);
        enc_raw_bits(e, k1, raw & ((1u << k1) - 1));
      }
    }
  } else {
    enc_bit(e, &ic->m_corr0, (U32)c);
  }
}

static void ic_compress(IC *ic, Enc *e, I32 pred, I32 real, U32 context) {
  I32 corr = real - pred;
  if (ic->corr_range) { /* bounded-bit wraparound into [corr_min, corr_max] */
    I32 corr_max = ic->corr_min + (I32)ic->corr_range - 1;
    if (corr < ic->corr_min) corr += (I32)ic->corr_range;
    else if (corr > corr_max) corr -= (I32)ic->corr_range;
  }
  ic_write_corr(ic, e, corr, &ic->m_bits[context]);
}

/* ------------------------------------------------------------------ */
/* streaming median of 5                                               */
/* ------------------------------------------------------------------ */

typedef struct {
  I32 v[5];
  int high;
} Med5;

static void med5_init(Med5 *m) { memset(m->v, 0, sizeof m->v); m->high = 1; }

static void med5_add(Med5 *m, I32 x) {
  I32 *v = m->v;
  if (m->high) {
    if (v[2] > x) {
      v[4] = v[3]; v[3] = v[2];
      if (v[0] > x) { v[2] = v[1]; v[1] = v[0]; v[0] = x; }
      else if (v[1] > x) { v[2] = v[1]; v[1] = x; }
      else v[2] = x;
    } else {
      if (v[3] < x) { v[4] = v[3]; v[3] = x; }
      else v[4] = x;
      m->high = 0;
    }
  } else {
    if (v[2] < x) {
      v[0] = v[1]; v[1] = v[2];
      if (v[4] < x) { v[2] = v[3]; v[3] = v[4]; v[4] = x; }
      else if (v[3] < x) { v[2] = v[3]; v[3] = x; }
      else v[2] = x;
    } else {
      if (v[1] > x) { v[0] = v[1]; v[1] = x; }
      else v[0] = x;
      m->high = 1;
    }
  }
}

static I32 med5_get(const Med5 *m) { return m->v[2]; }

/* ------------------------------------------------------------------ */
/* LAS point10 record layout helpers (little-endian byte access)       */
/* ------------------------------------------------------------------ */

static I32 rd_i32(const U8 *p) {
  return (I32)((U32)p[0] | ((U32)p[1] << 8) | ((U32)p[2] << 16) | ((U32)p[3] << 24));
}
static U16 rd_u16(const U8 *p) { return (U16)(p[0] | (p[1] << 8)); }
static void wr_i32(U8 *p, I32 v) {
  p[0] = (U8)v; p[1] = (U8)(v >> 8); p[2] = (U8)(v >> 16); p[3] = (U8)(v >> 24);
}
static void wr_u16(U8 *p, U16 v) { p[0] = (U8)v; p[1] = (U8)(v >> 8); }

/* v2 return-number context tables (part of the LAZ format definition) */
static const U8 NUMBER_RETURN_MAP[8][8] = {
    {15, 14, 13, 12, 11, 10, 9, 8},  {14, 0, 1, 3, 6, 10, 10, 9},
    {13, 1, 2, 4, 7, 11, 11, 10},    {12, 3, 4, 5, 8, 12, 12, 11},
    {11, 6, 7, 8, 9, 13, 13, 12},    {10, 10, 11, 12, 13, 14, 14, 13},
    {9, 10, 11, 12, 13, 14, 15, 14}, {8, 9, 10, 11, 12, 13, 14, 15}};
static const U8 NUMBER_RETURN_LEVEL[8][8] = {
    {0, 1, 2, 3, 4, 5, 6, 7}, {1, 0, 1, 2, 3, 4, 5, 6},
    {2, 1, 0, 1, 2, 3, 4, 5}, {3, 2, 1, 0, 1, 2, 3, 4},
    {4, 3, 2, 1, 0, 1, 2, 3}, {5, 4, 3, 2, 1, 0, 1, 2},
    {6, 5, 4, 3, 2, 1, 0, 1}, {7, 6, 5, 4, 3, 2, 1, 0}};

/* ------------------------------------------------------------------ */
/* POINT10 v2 item codec                                               */
/* ------------------------------------------------------------------ */

typedef struct {
  U8 last[20];
  U16 last_intensity[16];
  Med5 last_x_diff_median5[16];
  Med5 last_y_diff_median5[16];
  I32 last_height[8];
  Model m_changed_values;
  IC ic_intensity;
  Model m_scan_angle_rank[2];
  IC ic_point_source;
  Model *m_bit_byte[256];
  Model *m_classification[256];
  Model *m_user_data[256];
  IC ic_dx, ic_dy, ic_z;
  int alive;
} Point10v2;

static void p10_alloc(Point10v2 *s) {
  if (s->alive) return;
  memset(s, 0, sizeof *s);
  model_init(&s->m_changed_values, 64);
  ic_init(&s->ic_intensity, 16, 4);
  model_init(&s->m_scan_angle_rank[0], 256);
  model_init(&s->m_scan_angle_rank[1], 256);
  ic_init(&s->ic_point_source, 16, 1);
  ic_init(&s->ic_dx, 32, 2);
  ic_init(&s->ic_dy, 32, 22);
  ic_init(&s->ic_z, 32, 20);
  s->alive = 1;
}

static void p10_reinit_models(Point10v2 *s) {
  model_init(&s->m_changed_values, 64);
  model_init(&s->m_scan_angle_rank[0], 256);
  model_init(&s->m_scan_angle_rank[1], 256);
  for (int i = 0; i < 256; i++) {
    if (s->m_bit_byte[i]) model_init(s->m_bit_byte[i], 256);
    if (s->m_classification[i]) model_init(s->m_classification[i], 256);
    if (s->m_user_data[i]) model_init(s->m_user_data[i], 256);
  }
  /* re-init integer compressors (fresh model state per chunk) */
  ic_free(&s->ic_intensity); ic_init(&s->ic_intensity, 16, 4);
  ic_free(&s->ic_point_source); ic_init(&s->ic_point_source, 16, 1);
  ic_free(&s->ic_dx); ic_init(&s->ic_dx, 32, 2);
  ic_free(&s->ic_dy); ic_init(&s->ic_dy, 32, 22);
  ic_free(&s->ic_z); ic_init(&s->ic_z, 32, 20);
}

static void p10_init_chunk(Point10v2 *s, const U8 *first) {
  p10_alloc(s);
  p10_reinit_models(s);
  memcpy(s->last, first, 20);
  wr_u16(s->last + 12, 0); /* spec: last intensity starts at 0 */
  memset(s->last_intensity, 0, sizeof s->last_intensity);
  for (int i = 0; i < 16; i++) {
    med5_init(&s->last_x_diff_median5[i]);
    med5_init(&s->last_y_diff_median5[i]);
  }
  memset(s->last_height, 0, sizeof s->last_height);
}

static Model *lazy_model(Model **slot, U32 symbols) {
  if (!*slot) {
    *slot = (Model *)calloc(1, sizeof(Model));
    model_init(*slot, symbols);
  }
  return *slot;
}

static void p10_read(Point10v2 *s, Dec *d, U8 *item) {
  U8 *last = s->last;
  U32 changed = dec_symbol(d, &s->m_changed_values);
  if (changed & 32) {
    last[14] = (U8)dec_symbol(d, lazy_model(&s->m_bit_byte[last[14]], 256));
  }
  U32 r = last[14] & 7;            /* return number */
  U32 n = (last[14] >> 3) & 7;     /* number of returns */
  U32 m = NUMBER_RETURN_MAP[n][r];
  U32 l = NUMBER_RETURN_LEVEL[n][r];

  if (changed & 16) {
    U16 intensity = (U16)ic_decompress(&s->ic_intensity, d,
                                       (I32)s->last_intensity[m],
                                       m < 3 ? m : 3);
    wr_u16(last + 12, intensity);
    s->last_intensity[m] = intensity;
  } else {
    wr_u16(last + 12, s->last_intensity[m]);
  }
  if (changed & 8) {
    last[15] = (U8)dec_symbol(d, lazy_model(&s->m_classification[last[15]], 256));
  }
  if (changed & 4) {
    U32 f = (last[14] >> 6) & 1; /* scan direction flag */
    U32 val = dec_symbol(d, &s->m_scan_angle_rank[f]);
    last[16] = (U8)(val + last[16]); /* U8 wrap-around add */
  }
  if (changed & 2) {
    last[17] = (U8)dec_symbol(d, lazy_model(&s->m_user_data[last[17]], 256));
  }
  if (changed & 1) {
    U16 psid = (U16)ic_decompress(&s->ic_point_source, d, (I32)rd_u16(last + 18), 0);
    wr_u16(last + 18, psid);
  }

  /* x */
  I32 median = med5_get(&s->last_x_diff_median5[m]);
  I32 diff = ic_decompress(&s->ic_dx, d, median, n == 1);
  wr_i32(last + 0, rd_i32(last + 0) + diff);
  med5_add(&s->last_x_diff_median5[m], diff);

  /* y (context folds in dx's corrector width) */
  U32 k_bits = s->ic_dx.k;
  median = med5_get(&s->last_y_diff_median5[m]);
  diff = ic_decompress(&s->ic_dy, d, median,
                       (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
  wr_i32(last + 4, rd_i32(last + 4) + diff);
  med5_add(&s->last_y_diff_median5[m], diff);

  /* z (context folds in dx/dy corrector widths; predicted by level height) */
  k_bits = (s->ic_dx.k + s->ic_dy.k) / 2;
  I32 z = ic_decompress(&s->ic_z, d, s->last_height[l],
                        (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
  wr_i32(last + 8, z);
  s->last_height[l] = z;

  memcpy(item, last, 20);
}

static void p10_write(Point10v2 *s, Enc *e, const U8 *item) {
  U8 *last = s->last;
  U32 r = item[14] & 7, n = (item[14] >> 3) & 7;
  U32 m = NUMBER_RETURN_MAP[n][r];
  U32 l = NUMBER_RETURN_LEVEL[n][r];

  U32 changed = ((last[14] != item[14]) ? 32u : 0u) |
                ((s->last_intensity[m] != rd_u16(item + 12)) ? 16u : 0u) |
                ((last[15] != item[15]) ? 8u : 0u) |
                ((last[16] != item[16]) ? 4u : 0u) |
                ((last[17] != item[17]) ? 2u : 0u) |
                ((rd_u16(last + 18) != rd_u16(item + 18)) ? 1u : 0u);
  enc_symbol(e, &s->m_changed_values, changed);
  if (changed & 32) {
    enc_symbol(e, lazy_model(&s->m_bit_byte[last[14]], 256), item[14]);
    last[14] = item[14];
  }
  if (changed & 16) {
    ic_compress(&s->ic_intensity, e, (I32)s->last_intensity[m],
                (I32)rd_u16(item + 12), m < 3 ? m : 3);
    s->last_intensity[m] = rd_u16(item + 12);
  }
  wr_u16(last + 12, rd_u16(item + 12));
  if (changed & 8) {
    enc_symbol(e, lazy_model(&s->m_classification[last[15]], 256), item[15]);
    last[15] = item[15];
  }
  if (changed & 4) {
    U32 f = (item[14] >> 6) & 1;
    enc_symbol(e, &s->m_scan_angle_rank[f], (U8)(item[16] - last[16]));
    last[16] = item[16];
  }
  if (changed & 2) {
    enc_symbol(e, lazy_model(&s->m_user_data[last[17]], 256), item[17]);
    last[17] = item[17];
  }
  if (changed & 1) {
    ic_compress(&s->ic_point_source, e, (I32)rd_u16(last + 18),
                (I32)rd_u16(item + 18), 0);
    wr_u16(last + 18, rd_u16(item + 18));
  }

  I32 median = med5_get(&s->last_x_diff_median5[m]);
  I32 diff = rd_i32(item + 0) - rd_i32(last + 0);
  ic_compress(&s->ic_dx, e, median, diff, n == 1);
  med5_add(&s->last_x_diff_median5[m], diff);
  wr_i32(last + 0, rd_i32(item + 0));

  U32 k_bits = s->ic_dx.k;
  median = med5_get(&s->last_y_diff_median5[m]);
  diff = rd_i32(item + 4) - rd_i32(last + 4);
  ic_compress(&s->ic_dy, e, median, diff,
              (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
  med5_add(&s->last_y_diff_median5[m], diff);
  wr_i32(last + 4, rd_i32(item + 4));

  k_bits = (s->ic_dx.k + s->ic_dy.k) / 2;
  ic_compress(&s->ic_z, e, s->last_height[l], rd_i32(item + 8),
              (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
  s->last_height[l] = rd_i32(item + 8);
  wr_i32(last + 8, rd_i32(item + 8));
}

/* ------------------------------------------------------------------ */
/* GPSTIME11 v2 item codec                                             */
/* ------------------------------------------------------------------ */

#define GPS_MULTI 500
#define GPS_MULTI_MINUS (-10)
#define GPS_MULTI_UNCHANGED (GPS_MULTI - GPS_MULTI_MINUS + 1) /* 511 */
#define GPS_MULTI_CODE_FULL (GPS_MULTI - GPS_MULTI_MINUS + 2) /* 512 */
#define GPS_MULTI_TOTAL (GPS_MULTI - GPS_MULTI_MINUS + 6)     /* 516 */

typedef struct {
  U64 last_gpstime[4];
  I32 last_gpstime_diff[4];
  I32 multi_extreme_counter[4];
  U32 last, next;
  Model m_gpstime_multi, m_gpstime_0diff;
  IC ic_gpstime;
  int alive;
} Gps11;

static void gps_init_chunk(Gps11 *s, const U8 *first) {
  if (!s->alive) {
    memset(s, 0, sizeof *s);
    s->alive = 1;
  } else {
    ic_free(&s->ic_gpstime);
  }
  model_init(&s->m_gpstime_multi, GPS_MULTI_TOTAL);
  model_init(&s->m_gpstime_0diff, 6);
  ic_init(&s->ic_gpstime, 32, 9);
  memset(s->last_gpstime, 0, sizeof s->last_gpstime);
  memset(s->last_gpstime_diff, 0, sizeof s->last_gpstime_diff);
  memset(s->multi_extreme_counter, 0, sizeof s->multi_extreme_counter);
  s->last = 0;
  s->next = 0;
  memcpy(&s->last_gpstime[0], first, 8);
}

static void gps_read(Gps11 *s, Dec *d, U8 *item) {
  if (s->last_gpstime_diff[s->last] == 0) {
    U32 multi = dec_symbol(d, &s->m_gpstime_0diff);
    if (multi == 1) { /* the difference fits in 32 bits */
      I32 diff = ic_decompress(&s->ic_gpstime, d, 0, 0);
      s->last_gpstime_diff[s->last] = diff;
      s->last_gpstime[s->last] += (I64)diff;
      s->multi_extreme_counter[s->last] = 0;
    } else if (multi == 2) { /* a new 64-bit value */
      s->next = (s->next + 1) & 3;
      U32 hi = (U32)ic_decompress(&s->ic_gpstime, d,
                                  (I32)(s->last_gpstime[s->last] >> 32), 8);
      U32 lo = dec_raw_bits(d, 32);
      s->last_gpstime[s->next] = ((U64)hi << 32) | lo;
      s->last = s->next;
      s->last_gpstime_diff[s->last] = 0;
      s->multi_extreme_counter[s->last] = 0;
    } else if (multi > 2) { /* switch to another sequence */
      s->last = (s->last + multi - 2) & 3;
      gps_read(s, d, item);
      return;
    }
  } else {
    U32 multi = dec_symbol(d, &s->m_gpstime_multi);
    if (multi == 1) {
      I32 diff = ic_decompress(&s->ic_gpstime, d, s->last_gpstime_diff[s->last], 1);
      s->last_gpstime[s->last] += (I64)diff;
      s->last_gpstime_diff[s->last] = diff;
      s->multi_extreme_counter[s->last] = 0;
    } else if (multi < GPS_MULTI_UNCHANGED) {
      I32 gpstime_diff;
      if (multi == 0) {
        gpstime_diff = ic_decompress(&s->ic_gpstime, d, 0, 7);
        s->multi_extreme_counter[s->last]++;
        if (s->multi_extreme_counter[s->last] > 3) {
          s->last_gpstime_diff[s->last] = gpstime_diff;
          s->multi_extreme_counter[s->last] = 0;
        }
      } else if (multi < GPS_MULTI) {
        if (multi < 10)
          gpstime_diff = ic_decompress(
              &s->ic_gpstime, d, multi * s->last_gpstime_diff[s->last], 2);
        else
          gpstime_diff = ic_decompress(
              &s->ic_gpstime, d, multi * s->last_gpstime_diff[s->last], 3);
      } else if (multi == GPS_MULTI) {
        gpstime_diff = ic_decompress(&s->ic_gpstime, d,
                                     GPS_MULTI * s->last_gpstime_diff[s->last], 4);
        s->multi_extreme_counter[s->last]++;
        if (s->multi_extreme_counter[s->last] > 3) {
          s->last_gpstime_diff[s->last] = gpstime_diff;
          s->multi_extreme_counter[s->last] = 0;
        }
      } else { /* multi in (GPS_MULTI, GPS_MULTI_UNCHANGED): multipliers -1..-10 */
        I32 mneg = (I32)GPS_MULTI - (I32)multi;
        if (mneg > -10)
          gpstime_diff = ic_decompress(
              &s->ic_gpstime, d, mneg * s->last_gpstime_diff[s->last], 5);
        else
          gpstime_diff = ic_decompress(
              &s->ic_gpstime, d, mneg * s->last_gpstime_diff[s->last], 6);
        if (mneg == -10) {
          s->multi_extreme_counter[s->last]++;
          if (s->multi_extreme_counter[s->last] > 3) {
            s->last_gpstime_diff[s->last] = gpstime_diff;
            s->multi_extreme_counter[s->last] = 0;
          }
        }
      }
      s->last_gpstime[s->last] += (I64)gpstime_diff;
    } else if (multi == GPS_MULTI_CODE_FULL) {
      s->next = (s->next + 1) & 3;
      U32 hi = (U32)ic_decompress(&s->ic_gpstime, d,
                                  (I32)(s->last_gpstime[s->last] >> 32), 8);
      U32 lo = dec_raw_bits(d, 32);
      s->last_gpstime[s->next] = ((U64)hi << 32) | lo;
      s->last = s->next;
      s->last_gpstime_diff[s->last] = 0;
      s->multi_extreme_counter[s->last] = 0;
    } else if (multi >= GPS_MULTI_CODE_FULL + 1) {
      s->last = (s->last + multi - GPS_MULTI_CODE_FULL) & 3;
      gps_read(s, d, item);
      return;
    } else { /* multi == GPS_MULTI_UNCHANGED: same value */
    }
  }
  memcpy(item, &s->last_gpstime[s->last], 8);
}

static void gps_write(Gps11 *s, Enc *e, const U8 *item) {
  U64 gpstime;
  memcpy(&gpstime, item, 8);
  if (s->last_gpstime_diff[s->last] == 0) {
    if (gpstime == s->last_gpstime[s->last]) {
      enc_symbol(e, &s->m_gpstime_0diff, 0);
    } else {
      I64 diff64 = (I64)(gpstime - s->last_gpstime[s->last]);
      I32 diff = (I32)diff64;
      if ((I64)diff == diff64) {
        enc_symbol(e, &s->m_gpstime_0diff, 1);
        ic_compress(&s->ic_gpstime, e, 0, diff, 0);
        s->last_gpstime_diff[s->last] = diff;
        s->multi_extreme_counter[s->last] = 0;
        s->last_gpstime[s->last] = gpstime;
      } else {
        /* look for a matching older sequence */
        for (U32 i = 1; i < 4; i++) {
          U32 o = (s->last + i) & 3;
          I64 od = (I64)(gpstime - s->last_gpstime[o]);
          if ((I64)(I32)od == od) {
            enc_symbol(e, &s->m_gpstime_0diff, i + 2);
            s->last = o;
            gps_write(s, e, item);
            return;
          }
        }
        enc_symbol(e, &s->m_gpstime_0diff, 2);
        s->next = (s->next + 1) & 3;
        ic_compress(&s->ic_gpstime, e, (I32)(s->last_gpstime[s->last] >> 32),
                    (I32)(gpstime >> 32), 8);
        enc_raw_bits(e, 32, (U32)gpstime);
        s->last = s->next;
        s->last_gpstime[s->last] = gpstime;
        s->last_gpstime_diff[s->last] = 0;
        s->multi_extreme_counter[s->last] = 0;
      }
    }
  } else {
    if (gpstime == s->last_gpstime[s->last]) {
      enc_symbol(e, &s->m_gpstime_multi, GPS_MULTI_UNCHANGED);
      return;
    }
    I64 diff64 = (I64)(gpstime - s->last_gpstime[s->last]);
    I32 diff = (I32)diff64;
    if ((I64)diff == diff64) {
      /* fitting difference: quantized multiplier of the last diff */
      float multi_f = (float)diff / (float)s->last_gpstime_diff[s->last];
      I32 multi = (I32)(multi_f < 0 ? multi_f - 0.5f : multi_f + 0.5f);
      if (multi == 1) {
        enc_symbol(e, &s->m_gpstime_multi, 1);
        ic_compress(&s->ic_gpstime, e, s->last_gpstime_diff[s->last], diff, 1);
        s->last_gpstime_diff[s->last] = diff;
        s->multi_extreme_counter[s->last] = 0;
      } else if (multi > 0) {
        if (multi < GPS_MULTI) {
          enc_symbol(e, &s->m_gpstime_multi, (U32)multi);
          if (multi < 10)
            ic_compress(&s->ic_gpstime, e, multi * s->last_gpstime_diff[s->last],
                        diff, 2);
          else
            ic_compress(&s->ic_gpstime, e, multi * s->last_gpstime_diff[s->last],
                        diff, 3);
        } else {
          enc_symbol(e, &s->m_gpstime_multi, GPS_MULTI);
          ic_compress(&s->ic_gpstime, e,
                      GPS_MULTI * s->last_gpstime_diff[s->last], diff, 4);
          s->multi_extreme_counter[s->last]++;
          if (s->multi_extreme_counter[s->last] > 3) {
            s->last_gpstime_diff[s->last] = diff;
            s->multi_extreme_counter[s->last] = 0;
          }
        }
      } else if (multi < 0) {
        if (multi > -10) {
          enc_symbol(e, &s->m_gpstime_multi, (U32)(GPS_MULTI - multi));
          ic_compress(&s->ic_gpstime, e, multi * s->last_gpstime_diff[s->last],
                      diff, 5);
        } else {
          enc_symbol(e, &s->m_gpstime_multi, (U32)(GPS_MULTI + 10));
          ic_compress(&s->ic_gpstime, e, -10 * s->last_gpstime_diff[s->last],
                      diff, 6);
          s->multi_extreme_counter[s->last]++;
          if (s->multi_extreme_counter[s->last] > 3) {
            s->last_gpstime_diff[s->last] = diff;
            s->multi_extreme_counter[s->last] = 0;
          }
        }
      } else { /* multi == 0 */
        enc_symbol(e, &s->m_gpstime_multi, 0);
        ic_compress(&s->ic_gpstime, e, 0, diff, 7);
        s->multi_extreme_counter[s->last]++;
        if (s->multi_extreme_counter[s->last] > 3) {
          s->last_gpstime_diff[s->last] = diff;
          s->multi_extreme_counter[s->last] = 0;
        }
      }
      s->last_gpstime[s->last] = gpstime;
    } else {
      for (U32 i = 1; i < 4; i++) {
        U32 o = (s->last + i) & 3;
        I64 od = (I64)(gpstime - s->last_gpstime[o]);
        if ((I64)(I32)od == od) {
          enc_symbol(e, &s->m_gpstime_multi, GPS_MULTI_CODE_FULL + i);
          s->last = o;
          gps_write(s, e, item);
          return;
        }
      }
      enc_symbol(e, &s->m_gpstime_multi, GPS_MULTI_CODE_FULL);
      s->next = (s->next + 1) & 3;
      ic_compress(&s->ic_gpstime, e, (I32)(s->last_gpstime[s->last] >> 32),
                  (I32)(gpstime >> 32), 8);
      enc_raw_bits(e, 32, (U32)gpstime);
      s->last = s->next;
      s->last_gpstime[s->last] = gpstime;
      s->last_gpstime_diff[s->last] = 0;
      s->multi_extreme_counter[s->last] = 0;
    }
  }
}

/* ------------------------------------------------------------------ */
/* RGB12 v2 item codec                                                 */
/* ------------------------------------------------------------------ */

typedef struct {
  U16 last[3];
  Model m_byte_used;
  Model m_rgb_diff[6];
  int alive;
} Rgb12;

static U8 u8_clamp(I32 v) { return v < 0 ? 0 : (v > 255 ? 255 : (U8)v); }

static void rgb_init_chunk(Rgb12 *s, const U8 *first) {
  if (!s->alive) {
    memset(s, 0, sizeof *s);
    s->alive = 1;
  }
  model_init(&s->m_byte_used, 128);
  for (int i = 0; i < 6; i++) model_init(&s->m_rgb_diff[i], 256);
  s->last[0] = rd_u16(first + 0);
  s->last[1] = rd_u16(first + 2);
  s->last[2] = rd_u16(first + 4);
}

static void rgb_read(Rgb12 *s, Dec *d, U8 *item) {
  U32 sym = dec_symbol(d, &s->m_byte_used);
  U8 r_lo, r_hi, g_lo, g_hi, b_lo, b_hi;
  I32 corr, diff;
  if (sym & 1) {
    corr = (I32)dec_symbol(d, &s->m_rgb_diff[0]);
    r_lo = (U8)(corr + (s->last[0] & 0xFF));
  } else r_lo = s->last[0] & 0xFF;
  if (sym & 2) {
    corr = (I32)dec_symbol(d, &s->m_rgb_diff[1]);
    r_hi = (U8)(corr + (s->last[0] >> 8));
  } else r_hi = s->last[0] >> 8;
  if (sym & 64) {
    diff = (I32)r_lo - (I32)(s->last[0] & 0xFF);
    if (sym & 4) {
      corr = (I32)dec_symbol(d, &s->m_rgb_diff[2]);
      g_lo = (U8)(corr + u8_clamp(diff + (s->last[1] & 0xFF)));
    } else g_lo = s->last[1] & 0xFF;
    if (sym & 16) {
      I32 diff2 = (diff + ((I32)g_lo - (I32)(s->last[1] & 0xFF))) / 2;
      corr = (I32)dec_symbol(d, &s->m_rgb_diff[4]);
      b_lo = (U8)(corr + u8_clamp(diff2 + (s->last[2] & 0xFF)));
    } else b_lo = s->last[2] & 0xFF;
    diff = (I32)r_hi - (I32)(s->last[0] >> 8);
    if (sym & 8) {
      corr = (I32)dec_symbol(d, &s->m_rgb_diff[3]);
      g_hi = (U8)(corr + u8_clamp(diff + (s->last[1] >> 8)));
    } else g_hi = s->last[1] >> 8;
    if (sym & 32) {
      I32 diff2 = (diff + ((I32)g_hi - (I32)(s->last[1] >> 8))) / 2;
      corr = (I32)dec_symbol(d, &s->m_rgb_diff[5]);
      b_hi = (U8)(corr + u8_clamp(diff2 + (s->last[2] >> 8)));
    } else b_hi = s->last[2] >> 8;
  } else {
    g_lo = r_lo; g_hi = r_hi; b_lo = r_lo; b_hi = r_hi;
  }
  s->last[0] = (U16)(r_lo | (r_hi << 8));
  s->last[1] = (U16)(g_lo | (g_hi << 8));
  s->last[2] = (U16)(b_lo | (b_hi << 8));
  wr_u16(item + 0, s->last[0]);
  wr_u16(item + 2, s->last[1]);
  wr_u16(item + 4, s->last[2]);
}

static void rgb_write(Rgb12 *s, Enc *e, const U8 *item) {
  U16 r = rd_u16(item + 0), g = rd_u16(item + 2), b = rd_u16(item + 4);
  U8 r_lo = r & 0xFF, r_hi = r >> 8, g_lo = g & 0xFF, g_hi = g >> 8;
  U8 b_lo = b & 0xFF, b_hi = b >> 8;
  U8 lr_lo = s->last[0] & 0xFF, lr_hi = s->last[0] >> 8;
  U8 lg_lo = s->last[1] & 0xFF, lg_hi = s->last[1] >> 8;
  U8 lb_lo = s->last[2] & 0xFF, lb_hi = s->last[2] >> 8;
  U32 sym = 0;
  int flat = (r_lo == g_lo) && (r_lo == b_lo) && (r_hi == g_hi) && (r_hi == b_hi);
  /* bits mean "byte CHANGED vs last" (the predictor only shapes the corrector) */
  if (r_lo != lr_lo) sym |= 1;
  if (r_hi != lr_hi) sym |= 2;
  if (!flat) {
    sym |= 64;
    if (g_lo != lg_lo) sym |= 4;
    if (g_hi != lg_hi) sym |= 8;
    if (b_lo != lb_lo) sym |= 16;
    if (b_hi != lb_hi) sym |= 32;
  }
  I32 diff_lo = (I32)r_lo - lr_lo, diff_hi = (I32)r_hi - lr_hi;
  U8 pg_lo = u8_clamp(diff_lo + lg_lo);
  U8 pg_hi = u8_clamp(diff_hi + lg_hi);
  enc_symbol(e, &s->m_byte_used, sym);
  if (sym & 1) enc_symbol(e, &s->m_rgb_diff[0], (U8)(r_lo - lr_lo));
  if (sym & 2) enc_symbol(e, &s->m_rgb_diff[1], (U8)(r_hi - lr_hi));
  if (sym & 64) {
    if (sym & 4) enc_symbol(e, &s->m_rgb_diff[2], (U8)(g_lo - pg_lo));
    if (sym & 16) {
      I32 d2_lo = (diff_lo + ((I32)g_lo - lg_lo)) / 2;
      enc_symbol(e, &s->m_rgb_diff[4], (U8)(b_lo - u8_clamp(d2_lo + lb_lo)));
    }
    if (sym & 8) enc_symbol(e, &s->m_rgb_diff[3], (U8)(g_hi - pg_hi));
    if (sym & 32) {
      I32 d2_hi = (diff_hi + ((I32)g_hi - lg_hi)) / 2;
      enc_symbol(e, &s->m_rgb_diff[5], (U8)(b_hi - u8_clamp(d2_hi + lb_hi)));
    }
  }
  s->last[0] = r; s->last[1] = g; s->last[2] = b;
}

/* ------------------------------------------------------------------ */
/* BYTE v2 item codec (extra bytes)                                    */
/* ------------------------------------------------------------------ */

typedef struct {
  U32 count;
  U8 *last;
  Model *m_byte; /* [count], 256 symbols each */
  int alive;
} ByteV2;

static void byte_init_chunk(ByteV2 *s, U32 count, const U8 *first) {
  if (!s->alive) {
    memset(s, 0, sizeof *s);
    s->count = count;
    s->last = (U8 *)malloc(count);
    s->m_byte = (Model *)calloc(count, sizeof(Model));
    s->alive = 1;
  }
  for (U32 i = 0; i < count; i++) model_init(&s->m_byte[i], 256);
  memcpy(s->last, first, count);
}

static void byte_read(ByteV2 *s, Dec *d, U8 *item) {
  for (U32 i = 0; i < s->count; i++) {
    U32 val = dec_symbol(d, &s->m_byte[i]);
    s->last[i] = (U8)(val + s->last[i]);
    item[i] = s->last[i];
  }
}

static void byte_write(ByteV2 *s, Enc *e, const U8 *item) {
  for (U32 i = 0; i < s->count; i++) {
    enc_symbol(e, &s->m_byte[i], (U8)(item[i] - s->last[i]));
    s->last[i] = item[i];
  }
}

/* ------------------------------------------------------------------ */
/* chunked stream codec                                                */
/* ------------------------------------------------------------------ */

#define ITEM_BYTE 0
#define ITEM_POINT10 6
#define ITEM_GPSTIME11 7
#define ITEM_RGB12 8

typedef struct {
  Point10v2 p10;
  Gps11 gps;
  Rgb12 rgb;
  ByteV2 extra;
} ItemStates;

static void states_free(ItemStates *st) {
  if (st->p10.alive) {
    model_free(&st->p10.m_changed_values);
    model_free(&st->p10.m_scan_angle_rank[0]);
    model_free(&st->p10.m_scan_angle_rank[1]);
    for (int i = 0; i < 256; i++) {
      if (st->p10.m_bit_byte[i]) { model_free(st->p10.m_bit_byte[i]); free(st->p10.m_bit_byte[i]); }
      if (st->p10.m_classification[i]) { model_free(st->p10.m_classification[i]); free(st->p10.m_classification[i]); }
      if (st->p10.m_user_data[i]) { model_free(st->p10.m_user_data[i]); free(st->p10.m_user_data[i]); }
    }
    ic_free(&st->p10.ic_intensity);
    ic_free(&st->p10.ic_point_source);
    ic_free(&st->p10.ic_dx);
    ic_free(&st->p10.ic_dy);
    ic_free(&st->p10.ic_z);
  }
  if (st->gps.alive) {
    model_free(&st->gps.m_gpstime_multi);
    model_free(&st->gps.m_gpstime_0diff);
    ic_free(&st->gps.ic_gpstime);
  }
  if (st->rgb.alive) {
    model_free(&st->rgb.m_byte_used);
    for (int i = 0; i < 6; i++) model_free(&st->rgb.m_rgb_diff[i]);
  }
  if (st->extra.alive) {
    for (U32 i = 0; i < st->extra.count; i++) model_free(&st->extra.m_byte[i]);
    free(st->extra.m_byte);
    free(st->extra.last);
  }
  memset(st, 0, sizeof *st);
}

/* Decode a LASzip chunk table (u32 version=0, u32 nchunks, IC(32,2)-coded
 * byte sizes, each predicted from the previous — laszip's standard layout;
 * laz_encode above writes the same). Fills sizes[0..n) with per-chunk byte
 * counts; returns nchunks, or -1 on malformed input. Chunks are independently
 * coded (every chunk restarts its models and coder), so a decoded table makes
 * the stream seekable and the DECODE parallel: each worker runs laz_decode
 * over its own contiguous chunk range (formats/laz.py fans this out across
 * loader threads — the reference gets its ~30 MP/s LAZ rate the same way,
 * many laszip readers on different file regions). */
long laz_decode_chunk_table(const U8 *tab, long tab_len, U32 *sizes,
                            long max_chunks) {
  if (tab_len < 8) return -1;
  U32 version = (U32)tab[0] | ((U32)tab[1] << 8) | ((U32)tab[2] << 16)
      | ((U32)tab[3] << 24);
  U32 nchunks = (U32)tab[4] | ((U32)tab[5] << 8) | ((U32)tab[6] << 16)
      | ((U32)tab[7] << 24);
  if (version != 0 || (long)nchunks > max_chunks) return -1;
  Dec d;
  dec_init(&d, tab + 8, tab + tab_len);
  IC ic;
  ic_init(&ic, 32, 2);
  for (U32 i = 0; i < nchunks; i++)
    sizes[i] = (U32)ic_decompress(&ic, &d, i ? (I32)sizes[i - 1] : 0, 1);
  ic_free(&ic);
  return (long)nchunks;
}

/* Decode `npoints` records of `rec_size` bytes.  `item_types`/`item_sizes`
 * describe the LASzip items (from the LASzip VLR).  `in` points at the first
 * chunk (AFTER the 8-byte chunk table offset).  Returns 0 on success. */
long laz_decode(const U8 *in, long in_len, U8 *out, long npoints,
                long chunk_size, const U16 *item_types, const U16 *item_sizes,
                int nitems, long rec_size) {
  ItemStates st;
  memset(&st, 0, sizeof st);
  const U8 *p = in;
  const U8 *end = in + in_len;
  long done = 0;
  while (done < npoints) {
    long left = npoints - done;
    long n = left < chunk_size ? left : chunk_size;
    /* first point of the chunk is raw */
    U8 *rec = out + done * rec_size;
    if (p + rec_size > end) { states_free(&st); return -1; }
    memcpy(rec, p, rec_size);
    p += rec_size;
    long off = 0;
    for (int i = 0; i < nitems; i++) {
      switch (item_types[i]) {
        case ITEM_POINT10: p10_init_chunk(&st.p10, rec + off); break;
        case ITEM_GPSTIME11: gps_init_chunk(&st.gps, rec + off); break;
        case ITEM_RGB12: rgb_init_chunk(&st.rgb, rec + off); break;
        case ITEM_BYTE: byte_init_chunk(&st.extra, item_sizes[i], rec + off); break;
        default: states_free(&st); return -2;
      }
      off += item_sizes[i];
    }
    Dec d;
    dec_init(&d, p, end);
    for (long j = 1; j < n; j++) {
      rec = out + (done + j) * rec_size;
      off = 0;
      for (int i = 0; i < nitems; i++) {
        switch (item_types[i]) {
          case ITEM_POINT10: p10_read(&st.p10, &d, rec + off); break;
          case ITEM_GPSTIME11: gps_read(&st.gps, &d, rec + off); break;
          case ITEM_RGB12: rgb_read(&st.rgb, &d, rec + off); break;
          case ITEM_BYTE: byte_read(&st.extra, &d, rec + off); break;
        }
        off += item_sizes[i];
      }
    }
    p = d.in; /* decoder consumed exactly the chunk's bytes */
    done += n;
  }
  states_free(&st);
  return 0;
}

/* Encode into `out` (capacity out_cap).  Writes the chunked point stream
 * starting with the 8-byte chunk-table offset placeholder and ending with a
 * chunk table, exactly the layout readers expect after the LAS header+VLRs.
 * Returns total bytes written, or -1 if out of space. */
long laz_encode(const U8 *pts, long npoints, long chunk_size,
                const U16 *item_types, const U16 *item_sizes, int nitems,
                long rec_size, U8 *out, long out_cap) {
  ItemStates st;
  memset(&st, 0, sizeof st);
  U8 *o = out;
  U8 *end = out + out_cap;
  long nchunks = (npoints + chunk_size - 1) / chunk_size;
  U32 *chunk_bytes = (U32 *)malloc((size_t)(nchunks > 0 ? nchunks : 1) * 4);
  long ci = 0;
  if (o + 8 > end) { free(chunk_bytes); return -1; }
  o += 8; /* chunk table offset patched at the end */
  long done = 0;
  while (done < npoints) {
    U8 *chunk_start = o;
    long left = npoints - done;
    long n = left < chunk_size ? left : chunk_size;
    const U8 *rec = pts + done * rec_size;
    if (o + rec_size > end) { free(chunk_bytes); states_free(&st); return -1; }
    memcpy(o, rec, rec_size);
    o += rec_size;
    long off = 0;
    for (int i = 0; i < nitems; i++) {
      switch (item_types[i]) {
        case ITEM_POINT10: p10_init_chunk(&st.p10, rec + off); break;
        case ITEM_GPSTIME11: gps_init_chunk(&st.gps, rec + off); break;
        case ITEM_RGB12: rgb_init_chunk(&st.rgb, rec + off); break;
        case ITEM_BYTE: byte_init_chunk(&st.extra, item_sizes[i], rec + off); break;
        default: free(chunk_bytes); states_free(&st); return -2;
      }
      off += item_sizes[i];
    }
    Enc e;
    enc_init(&e, o, end);
    for (long j = 1; j < n; j++) {
      rec = pts + (done + j) * rec_size;
      off = 0;
      for (int i = 0; i < nitems; i++) {
        switch (item_types[i]) {
          case ITEM_POINT10: p10_write(&st.p10, &e, rec + off); break;
          case ITEM_GPSTIME11: gps_write(&st.gps, &e, rec + off); break;
          case ITEM_RGB12: rgb_write(&st.rgb, &e, rec + off); break;
          case ITEM_BYTE: byte_write(&st.extra, &e, rec + off); break;
        }
        off += item_sizes[i];
      }
    }
    enc_done(&e);
    if (e.overflow) { free(chunk_bytes); states_free(&st); return -1; }
    o = e.out;
    chunk_bytes[ci++] = (U32)(o - chunk_start);
    done += n;
  }
  states_free(&st);
  /* chunk table: u32 version=0, u32 nchunks, then IC(32,2)-coded sizes */
  long table_pos = o - out;
  if (o + 8 > end) { free(chunk_bytes); return -1; }
  o[0] = 0; o[1] = 0; o[2] = 0; o[3] = 0;
  o[4] = (U8)ci; o[5] = (U8)(ci >> 8); o[6] = (U8)(ci >> 16); o[7] = (U8)(ci >> 24);
  o += 8;
  {
    Enc e;
    enc_init(&e, o, end);
    IC ic;
    ic_init(&ic, 32, 2);
    for (long i = 0; i < ci; i++)
      ic_compress(&ic, &e, i ? (I32)chunk_bytes[i - 1] : 0, (I32)chunk_bytes[i], 1);
    enc_done(&e);
    ic_free(&ic);
    if (e.overflow) { free(chunk_bytes); return -1; }
    o = e.out;
  }
  /* patch the chunk table offset (relative to the start of `out`'s stream
   * position, which the caller translates to an absolute file offset) */
  out[0] = (U8)table_pos; out[1] = (U8)(table_pos >> 8);
  out[2] = (U8)(table_pos >> 16); out[3] = (U8)(table_pos >> 24);
  out[4] = (U8)(table_pos >> 32); out[5] = (U8)(table_pos >> 40);
  out[6] = (U8)(table_pos >> 48); out[7] = (U8)(table_pos >> 56);
  free(chunk_bytes);
  return o - out;
}

/* The card's busy time over a window, from CUPTI's activity records.
 *
 * CUPTI hands over filled buffers of records; each kernel, copy and fill
 * record keeps its device start and end, which this library appends to
 * one array. dc_busy() merges the intervals and returns the union's
 * length. No CUPTI header is needed: the entry points come in from the
 * caller (the library the process has loaded), and the records are read
 * at the offsets every record version since CUDA 9 shares: the kind at
 * 0, start at 16, end at 24 (kernels, copies and fills alike).
 */
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define KIND_MEMCPY 1
#define KIND_MEMSET 2
#define KIND_CONCURRENT_KERNEL 10
#define BUFFER_BYTES (8u << 20)

typedef void (*request_fn)(uint8_t **, size_t *, size_t *);
typedef void (*complete_fn)(void *, uint32_t, uint8_t *, size_t, size_t);
typedef int (*register_fn)(request_fn, complete_fn);
typedef int (*kind_fn)(int);
typedef int (*flush_fn)(uint32_t);
typedef int (*next_fn)(uint8_t *, size_t, void **);
typedef int (*dropped_fn)(void *, uint32_t, size_t *);

static const int KINDS[] = {KIND_MEMCPY, KIND_MEMSET, KIND_CONCURRENT_KERNEL};
#define N_KINDS (sizeof(KINDS) / sizeof(KINDS[0]))

static register_fn reg_cb;
static kind_fn enable_kind, disable_kind;
static flush_fn flush_all;
static next_fn next_record;
static dropped_fn n_dropped;

static pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
static uint64_t *iv;        /* start, end pairs */
static size_t n_iv, cap_iv;
static uint64_t dropped, buffers;
static int failed;

void dc_add(uint64_t start, uint64_t end) {
  pthread_mutex_lock(&mu);
  if (n_iv == cap_iv) {
    size_t cap = cap_iv ? 2 * cap_iv : (1u << 20);
    uint64_t *p = realloc(iv, cap * 2 * sizeof(uint64_t));
    if (!p) {
      failed = 1;
      pthread_mutex_unlock(&mu);
      return;
    }
    iv = p;
    cap_iv = cap;
  }
  iv[2 * n_iv] = start;
  iv[2 * n_iv + 1] = end;
  n_iv++;
  pthread_mutex_unlock(&mu);
}

static void on_request(uint8_t **buf, size_t *size, size_t *max_records) {
  *buf = aligned_alloc(8, BUFFER_BYTES);
  *size = *buf ? BUFFER_BYTES : 0;
  *max_records = 0;
  if (!*buf) failed = 1;
}

static void on_complete(void *ctx, uint32_t stream, uint8_t *buf, size_t size,
                        size_t valid) {
  void *rec = NULL;
  size_t lost = 0;
  (void)size;
  while (next_record(buf, valid, &rec) == 0) {
    uint32_t kind = *(const uint32_t *)rec;
    if (kind == KIND_MEMCPY || kind == KIND_MEMSET ||
        kind == KIND_CONCURRENT_KERNEL) {
      const uint8_t *r = (const uint8_t *)rec;
      uint64_t start, end;
      memcpy(&start, r + 16, 8);
      memcpy(&end, r + 24, 8);
      dc_add(start, end);
    }
  }
  if (n_dropped && n_dropped(ctx, stream, &lost) == 0 && lost) {
    pthread_mutex_lock(&mu);
    dropped += lost;
    pthread_mutex_unlock(&mu);
  }
  pthread_mutex_lock(&mu);
  buffers++;
  pthread_mutex_unlock(&mu);
  free(buf);
}

int dc_init(void *reg, void *enable, void *disable, void *flush, void *next,
            void *drop) {
  reg_cb = (register_fn)reg;
  enable_kind = (kind_fn)enable;
  disable_kind = (kind_fn)disable;
  flush_all = (flush_fn)flush;
  next_record = (next_fn)next;
  n_dropped = (dropped_fn)drop;
  return reg_cb(on_request, on_complete);
}

void dc_reset(void) {
  pthread_mutex_lock(&mu);
  n_iv = 0;
  dropped = buffers = 0;
  failed = 0;
  pthread_mutex_unlock(&mu);
}

int dc_start(void) {
  for (size_t i = 0; i < N_KINDS; i++) {
    int rc = enable_kind(KINDS[i]);
    if (rc) return rc;
  }
  return 0;
}

int dc_stop(void) {
  int rc = flush_all(1);
  for (size_t i = 0; i < N_KINDS; i++) disable_kind(KINDS[i]);
  return rc ? rc : flush_all(1);
}

static int by_start(const void *a, const void *b) {
  uint64_t x = *(const uint64_t *)a, y = *(const uint64_t *)b;
  return x < y ? -1 : x > y;
}

/* out: busy ns, intervals, first start, last end, dropped, buffers,
 * failed. */
void dc_busy(uint64_t *out) {
  uint64_t busy = 0, s = 0, e = 0, first = 0, last = 0;
  pthread_mutex_lock(&mu);
  qsort(iv, n_iv, 2 * sizeof(uint64_t), by_start);
  for (size_t i = 0; i < n_iv; i++) {
    uint64_t a = iv[2 * i], b = iv[2 * i + 1];
    if (b < a) b = a;
    if (i == 0) {
      s = a;
      e = b;
      first = a;
    } else if (a <= e) {
      if (b > e) e = b;
    } else {
      busy += e - s;
      s = a;
      e = b;
    }
    if (b > last) last = b;
  }
  if (n_iv) busy += e - s;
  out[0] = busy;
  out[1] = n_iv;
  out[2] = first;
  out[3] = last;
  out[4] = dropped;
  out[5] = buffers;
  out[6] = failed;
  pthread_mutex_unlock(&mu);
}

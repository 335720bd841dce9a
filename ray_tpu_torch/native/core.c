/* ray_tpu_torch native core: the latency/throughput-critical leaves the
 * Python runtime can't do well while holding the GIL.
 *
 * Parity intent: the reference implements its mutable-object wait
 * loops and checksum paths in C++ (src/ray/core_worker/
 * experimental_mutable_object_manager.cc waits on futex-backed
 * semaphores; src/ray/util crc32c). Here:
 *
 *  - rtpu_wait_u64s_ge: spin/backoff until `count` contiguous
 *    little-endian u64 words are all >= value. Called through ctypes,
 *    so the GIL is RELEASED for the whole wait — the Python spin loop
 *    it replaces held the GIL between checks, actively starving the
 *    peer thread/process it was waiting on (measurably so on 1-core
 *    hosts). Used for the DAG shm-channel writer ack-gate and reader
 *    seq-gate.
 *  - rtpu_crc32c / rtpu_masked_crc32c: slice-by-8 software CRC32C
 *    (Castagnoli) with the TFRecord masking, ~GB/s vs ~MB/s for the
 *    pure-Python table loop.
 *
 *  - frame engine (r7): the wire hot path of _private/protocol.py /
 *    wire.py. rtpu_reader_* is a per-connection read pump — blocking
 *    read(2) with the GIL released, EINTR retry, length-prefix
 *    reassembly in a C-owned buffer, max-frame sanity bound — that
 *    returns one-or-more complete frames per call (the reference gets
 *    this from its C++ core-worker/raylet RPC stack; the Python
 *    recv/concat loop it replaces held the GIL for every chunk).
 *    rtpu_writev_full flushes a coalesced frame burst as ONE
 *    scatter-gather syscall with zero joined-bytes copies.
 *    rtpu_env_{encode,decode} / rtpu_batch_{encode,split} are a
 *    protobuf-wire-format fast path for the hot Envelope shape
 *    (version/type/rid varint+string header, py_body bytes, BatchFrame
 *    sub-frame offset/length views) so per-frame dispatch stops paying
 *    Python protobuf object overhead; anything they can't parse falls
 *    back to the full protobuf codec.
 *
 * Built on demand by ray_tpu_torch/native/__init__.py with the host cc; the
 * Python fallbacks remain when no compiler is available.
 */
#include <errno.h>
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <sched.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

static inline uint64_t now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

/* Wait until words[0..count) are all >= value.
 * timeout_ns < 0 means no deadline. Returns 0 on success, 1 on
 * timeout. Words are written by other processes with aligned stores.
 * The gate words are read with ACQUIRE ordering: passing the gate must
 * order the caller's subsequent payload reads after the writer's
 * pre-publish payload stores, or a weakly-ordered CPU (aarch64) could
 * serve stale payload bytes through a freshly-opened gate. (On x86-64
 * plain loads already have acquire semantics; the builtin costs
 * nothing there.) Writers should publish the gate word with a
 * release-ordered store — CPython's mmap slice-assign stores are plain,
 * which is the remaining theoretical gap on ARM writers; the C-side
 * acquire at least restores the documented reader-side guarantee. */
int rtpu_wait_u64s_ge(const volatile uint64_t *words, int count,
                      uint64_t value, int64_t timeout_ns) {
    uint64_t deadline = 0;
    int have_deadline = timeout_ns >= 0;
    if (have_deadline)
        deadline = now_ns() + (uint64_t)timeout_ns;
    long sleep_ns = 20000;              /* 20 us */
    int spins = 0;
    for (;;) {
        int ok = 1;
        for (int i = 0; i < count; i++) {
            if (__atomic_load_n(&words[i], __ATOMIC_ACQUIRE) < value) {
                ok = 0;
                break;
            }
        }
        if (ok)
            return 0;
        if (++spins < 2000) {
            /* hot phase: burn ~tens of µs re-checking; yield so a
             * same-core peer can make progress */
            if ((spins & 63) == 0)
                sched_yield();
            continue;
        }
        if (have_deadline && now_ns() > deadline)
            return 1;
        struct timespec ts = {0, sleep_ns};
        nanosleep(&ts, NULL);
        if (sleep_ns < 1000000)         /* cap at 1 ms */
            sleep_ns += sleep_ns / 2;
    }
}

/* ---------------- CRC32C (Castagnoli), slice-by-8 ---------------- */
static uint32_t crc_table[8][256];
static int crc_ready = 0;

/* Table init runs at library load (dlopen happens under the loader's
 * Python-side lock) — a lazy flag without barriers would race two
 * GIL-released callers on weakly-ordered CPUs. */
static void crc_init(void) __attribute__((constructor));

static void crc_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c >> 1) ^ (0x82F63B78u & (~(c & 1) + 1));
        crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = crc_table[0][i];
        for (int t = 1; t < 8; t++) {
            c = crc_table[0][c & 0xFF] ^ (c >> 8);
            crc_table[t][i] = c;
        }
    }
    crc_ready = 1;
}

uint32_t rtpu_crc32c(const uint8_t *buf, size_t len) {
    if (!crc_ready)
        crc_init();
    uint32_t crc = 0xFFFFFFFFu;
    while (len >= 8) {
        crc ^= (uint32_t)buf[0] | ((uint32_t)buf[1] << 8)
             | ((uint32_t)buf[2] << 16) | ((uint32_t)buf[3] << 24);
        uint32_t hi = (uint32_t)buf[4] | ((uint32_t)buf[5] << 8)
                    | ((uint32_t)buf[6] << 16) | ((uint32_t)buf[7] << 24);
        crc = crc_table[7][crc & 0xFF]
            ^ crc_table[6][(crc >> 8) & 0xFF]
            ^ crc_table[5][(crc >> 16) & 0xFF]
            ^ crc_table[4][crc >> 24]
            ^ crc_table[3][hi & 0xFF]
            ^ crc_table[2][(hi >> 8) & 0xFF]
            ^ crc_table[1][(hi >> 16) & 0xFF]
            ^ crc_table[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len--)
        crc = crc_table[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

/* TFRecord framing mask. */
uint32_t rtpu_masked_crc32c(const uint8_t *buf, size_t len) {
    uint32_t crc = rtpu_crc32c(buf, len);
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

/* GIL-released bulk copy (r12 object-plane land path): Python's
 * mv[a:b] = src holds the GIL for the whole memcpy, which at multi-MB
 * chunk sizes starves every other runtime thread (reader pumps,
 * schedulers) for milliseconds per chunk. Called through ctypes the
 * copy runs with the GIL released; the caller guarantees both buffers
 * outlive the call and the ranges do not overlap. */
void rtpu_memcpy(uint8_t *dst, const uint8_t *src, size_t n) {
    memcpy(dst, src, n);
}

/* ================== frame engine: socket read pump ==================
 *
 * Wire framing (protocol.py): every frame is an 8-byte little-endian
 * length prefix followed by that many body bytes. The reader owns a
 * growable reassembly buffer; pump() blocks in read(2) — GIL released
 * via the ctypes call — until at least one COMPLETE frame is buffered,
 * then the caller iterates frames with next(). Frame pointers stay
 * valid until the following pump() (compaction happens only there). */

typedef struct {
    uint8_t *buf;
    size_t cap;
    size_t start, end;          /* valid bytes are buf[start..end) */
    uint64_t max_frame;
} rtpu_reader;

/* pump() return codes (>0 = that many complete frames are ready) */
#define RTPU_PUMP_EOF       0   /* peer closed (clean or mid-frame)   */
#define RTPU_PUMP_ERR     (-1)  /* read(2) failed (see errno caveat)  */
#define RTPU_PUMP_TOOBIG  (-2)  /* length prefix exceeds max_frame    */
#define RTPU_PUMP_NOMEM   (-3)  /* reassembly buffer grow failed      */
#define RTPU_PUMP_AGAIN   (-4)  /* pump_nb: kernel dry, no frame yet  */

rtpu_reader *rtpu_reader_new(uint64_t max_frame) {
    rtpu_reader *r = calloc(1, sizeof *r);
    if (!r)
        return NULL;
    r->cap = 1 << 16;
    r->buf = malloc(r->cap);
    if (!r->buf) {
        free(r);
        return NULL;
    }
    r->max_frame = max_frame ? max_frame : ((uint64_t)1 << 30);
    return r;
}

void rtpu_reader_free(rtpu_reader *r) {
    if (r) {
        free(r->buf);
        free(r);
    }
}

static inline uint64_t rd_u64le(const uint8_t *p) {
    uint64_t v = 0;
    for (int i = 7; i >= 0; i--)
        v = (v << 8) | p[i];
    return v;
}

/* Count complete frames buffered from start. Frames BEFORE a corrupt
 * (oversized) prefix still count — they are dispatched first and the
 * next pump reports the corruption. */
static long rd_count(const rtpu_reader *r) {
    size_t off = r->start;
    long n = 0;
    while (r->end - off >= 8) {
        uint64_t len = rd_u64le(r->buf + off);
        if (len > r->max_frame)
            return n > 0 ? n : RTPU_PUMP_TOOBIG;
        if ((uint64_t)(r->end - off - 8) < len)
            break;
        off += 8 + (size_t)len;
        n++;
    }
    return n;
}

/* Compact + size the reassembly buffer for the next read: shrink
 * after a large-frame spike, grow toward the pending frame's length.
 * Returns 0, or RTPU_PUMP_NOMEM when a required grow failed. */
static long rd_make_room(rtpu_reader *r) {
    if (r->start > 0) {
        memmove(r->buf, r->buf + r->start, r->end - r->start);
        r->end -= r->start;
        r->start = 0;
    }
    /* shrink after a large-frame spike: steady-state control
     * frames are a few hundred bytes, so a buffer grown for one
     * multi-MB state reply must not stay pinned for the
     * connection's lifetime. Shrink when the buffered remainder
     * uses under a quarter of a >1 MiB buffer; shrink-realloc
     * failure just keeps the old buffer. */
    if (r->cap > (1 << 20) && r->end < r->cap / 4) {
        size_t ncap = 1 << 16;
        while (ncap < r->end * 2)
            ncap *= 2;
        uint8_t *nbuf = realloc(r->buf, ncap);
        if (nbuf) {
            r->buf = nbuf;
            r->cap = ncap;
        }
    }
    size_t target = r->end + (1 << 16);
    if (r->end >= 8) {
        uint64_t len = rd_u64le(r->buf);        /* <= max_frame here */
        if (8 + len > (uint64_t)target)
            target = (size_t)(8 + len);
    }
    if (r->cap < target) {
        size_t ncap = r->cap;
        while (ncap < target)
            ncap *= 2;
        uint8_t *nbuf = realloc(r->buf, ncap);
        if (!nbuf)
            return RTPU_PUMP_NOMEM;
        r->buf = nbuf;
        r->cap = ncap;
    }
    return 0;
}

long rtpu_reader_pump(rtpu_reader *r, int fd) {
    for (;;) {
        long n = rd_count(r);
        if (n != 0)
            return n;                   /* frames ready, or TOOBIG */
        if ((n = rd_make_room(r)) != 0)
            return n;
        ssize_t got = read(fd, r->buf + r->end, r->cap - r->end);
        if (got < 0) {
            if (errno == EINTR)
                continue;               /* signal delivery: retry */
            return RTPU_PUMP_ERR;
        }
        if (got == 0)
            return RTPU_PUMP_EOF;
        r->end += (size_t)got;
    }
}

/* Non-blocking pump for the epoll loop (r10): recv(MSG_DONTWAIT), so
 * the fd's own flags stay untouched — the blocking send paths share
 * the open file description and must not turn non-blocking. Drains
 * the socket until at least one complete frame is buffered or the
 * kernel runs dry; RTPU_PUMP_AGAIN means "no complete frame yet,
 * wait for the next readiness event" (level-triggered epoll re-arms
 * by itself). Sockets only — every wire connection is one. */
long rtpu_reader_pump_nb(rtpu_reader *r, int fd) {
    for (;;) {
        long n = rd_count(r);
        if (n != 0)
            return n;                   /* frames ready, or TOOBIG */
        if ((n = rd_make_room(r)) != 0)
            return n;
        ssize_t got = recv(fd, r->buf + r->end, r->cap - r->end,
                           MSG_DONTWAIT);
        if (got < 0) {
            if (errno == EINTR)
                continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK)
                return RTPU_PUMP_AGAIN;
            return RTPU_PUMP_ERR;
        }
        if (got == 0)
            return RTPU_PUMP_EOF;
        r->end += (size_t)got;
    }
}

/* ------------------- epoll poller (r10 event loop) -------------------
 *
 * One epoll instance drives every registered connection's read side
 * (replacing thread-per-connection reads on the head and agents). All
 * calls arrive through ctypes, so the wait blocks with the GIL
 * released. Level-triggered: a fd whose pump left buffered kernel
 * bytes is simply reported again. Registration/removal from other
 * threads while a wait is in flight is kernel-supported. */

int rtpu_poller_new(void) {
    int fd = epoll_create1(EPOLL_CLOEXEC);
    return fd >= 0 ? fd : -errno;
}

int rtpu_poller_add(int epfd, int fd) {
    struct epoll_event ev;
    memset(&ev, 0, sizeof ev);
    ev.events = EPOLLIN | EPOLLRDHUP;   /* level-triggered */
    ev.data.fd = fd;
    return epoll_ctl(epfd, EPOLL_CTL_ADD, fd, &ev) == 0 ? 0 : -errno;
}

int rtpu_poller_del(int epfd, int fd) {
    struct epoll_event ev;               /* non-NULL for old kernels */
    memset(&ev, 0, sizeof ev);
    return epoll_ctl(epfd, EPOLL_CTL_DEL, fd, &ev) == 0 ? 0 : -errno;
}

/* Wait up to timeout_ms for readiness; fills fds[0..ret) with the
 * ready fd numbers (EPOLLIN/HUP/ERR all count — the pump surfaces
 * EOF/errors itself). 0 on timeout or EINTR; -errno on failure. */
long rtpu_poller_wait(int epfd, int *fds, long max, int timeout_ms) {
    struct epoll_event evs[64];
    int cap = max < 64 ? (int)max : 64;
    if (cap <= 0)
        return 0;
    int n = epoll_wait(epfd, evs, cap, timeout_ms);
    if (n < 0)
        return errno == EINTR ? 0 : -(long)errno;
    for (int i = 0; i < n; i++)
        fds[i] = evs[i].data.fd;
    return n;
}

/* Next complete frame body (and its length), or NULL when the buffered
 * data holds no further complete frame. Consumes the frame. */
const uint8_t *rtpu_reader_next(rtpu_reader *r, uint64_t *len_out) {
    if (r->end - r->start < 8)
        return NULL;
    uint64_t len = rd_u64le(r->buf + r->start);
    if (len > r->max_frame || (uint64_t)(r->end - r->start - 8) < len)
        return NULL;
    const uint8_t *body = r->buf + r->start + 8;
    r->start += 8 + (size_t)len;
    *len_out = len;
    return body;
}

/* ------------------- scatter-gather frame flush -------------------
 * Write EVERY byte of the iovec array (mutated in place on partial
 * writes) as few writev(2) syscalls as possible, GIL released, EINTR
 * retried. Returns 0 on success or -errno (EAGAIN = the socket's
 * SO_SNDTIMEO budget expired mid-write: the stream is desynced and the
 * caller must kill the connection, matching the sendall() contract).
 * Python runs with SIGPIPE ignored, so a dead peer is -EPIPE. */
long rtpu_writev_full(int fd, struct iovec *iov, long cnt) {
    while (cnt > 0) {
        int batch = cnt > 1024 ? 1024 : (int)cnt;   /* IOV_MAX floor */
        ssize_t wrote = writev(fd, iov, batch);
        if (wrote < 0) {
            if (errno == EINTR)
                continue;
            return -(long)errno;
        }
        size_t w = (size_t)wrote;
        while (cnt > 0 && w >= iov->iov_len) {
            w -= iov->iov_len;
            iov++;
            cnt--;
        }
        if (cnt > 0 && w > 0) {
            iov->iov_base = (uint8_t *)iov->iov_base + w;
            iov->iov_len -= w;
        }
    }
    return 0;
}

/* ================ Envelope codec (protobuf wire format) ================
 *
 * Hand-rolled encoder/decoder for the ONE message shape on the hot
 * path — ray_tpu.wire.Envelope:
 *   field 1  version  uint32   (varint,  tag 0x08)
 *   field 2  type     string   (len-del, tag 0x12)
 *   field 3  rid      uint64   (varint,  tag 0x18)
 *   field 4  fields   message  (len-del, tag 0x22)  [structural plane]
 *   field 5  py_body  bytes    (len-del, tag 0x2a)
 *   field 6  batch    message  (len-del, tag 0x32)  [BatchFrame]
 *   field 7  trace_id    fixed64 (tag 0x39)  [tracing plane, MINOR 2]
 *   field 8  parent_span fixed64 (tag 0x41)
 * BatchFrame: field 1 repeated Envelope (len-del, tag 0x0a).
 *
 * The decoder returns OFFSET/LENGTH views into the caller's buffer —
 * no allocation, no copies; unknown fields (future MINORs) are
 * skipped; anything irregular (truncated varint, duplicate submessage
 * fields whose protobuf semantics are merge-not-replace) returns -1
 * and the Python side falls back to the real protobuf parser, which
 * stays the arbiter of malformed input. */

typedef struct {
    uint32_t version;
    uint64_t rid;
    int64_t type_off, type_len;
    int64_t body_off, body_len;         /* py_body */
    int64_t fields_off, fields_len;
    int64_t batch_off, batch_len;
    uint64_t trace_id, parent_span;     /* tracing plane; 0 = unset */
    int64_t raw_off, raw_len;           /* raw bulk payload (MINOR 5) */
} rtpu_env_view;

static int pb_varint(const uint8_t *b, uint64_t len, uint64_t *pos,
                     uint64_t *out) {
    uint64_t v = 0;
    int shift = 0;
    while (*pos < len && shift < 64) {
        uint8_t c = b[(*pos)++];
        v |= (uint64_t)(c & 0x7f) << shift;
        if (!(c & 0x80)) {
            *out = v;
            return 0;
        }
        shift += 7;
    }
    return -1;
}

static int pb_skip(const uint8_t *b, uint64_t len, uint64_t *pos,
                   uint32_t wt) {
    uint64_t tmp;
    switch (wt) {
    case 0:                             /* varint */
        return pb_varint(b, len, pos, &tmp);
    case 1:                             /* fixed64 */
        if (len - *pos < 8)
            return -1;
        *pos += 8;
        return 0;
    case 2:                             /* length-delimited */
        if (pb_varint(b, len, pos, &tmp))
            return -1;
        if (len - *pos < tmp)
            return -1;
        *pos += tmp;
        return 0;
    case 5:                             /* fixed32 */
        if (len - *pos < 4)
            return -1;
        *pos += 4;
        return 0;
    default:                            /* groups: unsupported */
        return -1;
    }
}

int rtpu_env_decode(const uint8_t *buf, uint64_t len, rtpu_env_view *v) {
    memset(v, 0, sizeof *v);
    v->type_off = v->body_off = v->fields_off = v->batch_off = -1;
    v->raw_off = -1;
    uint64_t pos = 0;
    while (pos < len) {
        uint64_t tag, n;
        if (pb_varint(buf, len, &pos, &tag))
            return -1;
        uint32_t fno = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
        if (fno == 1 && wt == 0) {
            if (pb_varint(buf, len, &pos, &n))
                return -1;
            v->version = (uint32_t)n;   /* uint32: truncate like upb */
        } else if (fno == 3 && wt == 0) {
            if (pb_varint(buf, len, &pos, &n))
                return -1;
            v->rid = n;
        } else if ((fno == 7 || fno == 8) && wt == 1) {
            if (len - pos < 8)
                return -1;
            uint64_t x = 0;
            for (int i = 7; i >= 0; i--)
                x = (x << 8) | buf[pos + i];
            pos += 8;
            if (fno == 7)
                v->trace_id = x;
            else
                v->parent_span = x;
        } else if ((fno == 2 || fno == 4 || fno == 5 || fno == 6
                    || fno == 9) && wt == 2) {
            if (pb_varint(buf, len, &pos, &n) || len - pos < n)
                return -1;
            int64_t *off, *fl;
            switch (fno) {
            case 2:  off = &v->type_off;   fl = &v->type_len;   break;
            case 4:  off = &v->fields_off; fl = &v->fields_len; break;
            case 5:  off = &v->body_off;   fl = &v->body_len;   break;
            case 9:  off = &v->raw_off;    fl = &v->raw_len;    break;
            default: off = &v->batch_off;  fl = &v->batch_len;  break;
            }
            /* duplicate submessage/scalar-bytes fields: protobuf
             * merge/last-wins semantics — punt to the real parser */
            if (*off >= 0)
                return -1;
            *off = (int64_t)pos;
            *fl = (int64_t)n;
            pos += n;
        } else {
            if (pb_skip(buf, len, &pos, wt))
                return -1;              /* unknown field: skip */
        }
    }
    return 0;
}

/* Split a BatchFrame submessage (bytes at buf[0..len)) into sub-
 * Envelope views. Fills up to `max` (offset, length) pairs; returns
 * the TOTAL sub-frame count (caller re-calls with bigger arrays when
 * it exceeds max) or -1 on malformed input. */
long rtpu_batch_split(const uint8_t *buf, uint64_t len,
                      uint64_t *offs, uint64_t *lens, long max) {
    uint64_t pos = 0;
    long n = 0;
    while (pos < len) {
        uint64_t tag, sub;
        if (pb_varint(buf, len, &pos, &tag))
            return -1;
        if ((tag >> 3) == 1 && (tag & 7) == 2) {
            if (pb_varint(buf, len, &pos, &sub) || len - pos < sub)
                return -1;
            if (n < max) {
                offs[n] = pos;
                lens[n] = sub;
            }
            n++;
            pos += sub;
        } else {
            if (pb_skip(buf, len, &pos, (uint32_t)(tag & 7)))
                return -1;
        }
    }
    return n;
}

static inline uint64_t varint_size(uint64_t v) {
    uint64_t n = 1;
    while (v >= 0x80) {
        v >>= 7;
        n++;
    }
    return n;
}

static inline void put_varint(uint8_t **p, uint64_t v) {
    while (v >= 0x80) {
        *(*p)++ = (uint8_t)v | 0x80;
        v >>= 7;
    }
    *(*p)++ = (uint8_t)v;
}

/* Envelope HEADER encode: every field before the trailing length-
 * delimited payload, plus (when last_tag != 0) that payload field's
 * key byte and length varint — the caller appends the payload bytes
 * itself (scatter-gather emit: the pickled body / batch interior goes
 * to writev as its own iovec, never copied into the envelope buffer).
 * last_tag is 0x2a for py_body, 0x32 for batch (emitted even with
 * payload_len 0: submessage presence), 0 for no payload field.
 * Zero-valued scalar fields are omitted, matching proto3 canonical
 * output. Returns bytes written, or -1 when cap is too small. */
long rtpu_env_encode_header(uint32_t version,
                            const uint8_t *type, uint64_t type_len,
                            uint64_t rid, uint32_t last_tag,
                            uint64_t payload_len,
                            uint8_t *out, uint64_t cap) {
    uint64_t need = 0;
    if (version)
        need += 1 + varint_size(version);
    if (type_len)
        need += 1 + varint_size(type_len) + type_len;
    if (rid)
        need += 1 + varint_size(rid);
    if (last_tag)
        need += 1 + varint_size(payload_len);
    if (need > cap)
        return -1;
    uint8_t *p = out;
    if (version) {
        *p++ = 0x08;
        put_varint(&p, version);
    }
    if (type_len) {
        *p++ = 0x12;
        put_varint(&p, type_len);
        memcpy(p, type, type_len);
        p += type_len;
    }
    if (rid) {
        *p++ = 0x18;
        put_varint(&p, rid);
    }
    if (last_tag) {
        *p++ = (uint8_t)last_tag;
        put_varint(&p, payload_len);
    }
    return (long)(p - out);
}

/* Serialize a Python-plane Envelope (header + opaque py_body). Zero-
 * valued/empty fields are omitted, matching proto3 canonical output.
 * Returns bytes written, or -1 when cap is too small. */
long rtpu_env_encode(uint32_t version,
                     const uint8_t *type, uint64_t type_len,
                     uint64_t rid,
                     const uint8_t *body, uint64_t body_len,
                     uint8_t *out, uint64_t cap) {
    long n = rtpu_env_encode_header(version, type, type_len, rid,
                                    body_len ? 0x2a : 0, body_len,
                                    out, cap);
    if (n < 0 || (uint64_t)n + body_len > cap)
        return -1;
    if (body_len)
        memcpy(out + n, body, body_len);
    return n + (long)body_len;
}

/* Serialize a BatchFrame Envelope from n pre-serialized sub-Envelope
 * buffers: one C-side assembly instead of per-frame Python protobuf
 * work. Returns bytes written, or -1 when cap is too small. */
long rtpu_batch_encode(uint32_t version,
                       const uint8_t *type, uint64_t type_len,
                       const uint8_t *const *subs,
                       const uint64_t *sub_lens, long n,
                       uint8_t *out, uint64_t cap) {
    uint64_t inner = 0;
    for (long i = 0; i < n; i++)
        inner += 1 + varint_size(sub_lens[i]) + sub_lens[i];
    uint64_t need = 1 + varint_size(inner) + inner;
    if (version)
        need += 1 + varint_size(version);
    if (type_len)
        need += 1 + varint_size(type_len) + type_len;
    if (need > cap)
        return -1;
    uint8_t *p = out;
    if (version) {
        *p++ = 0x08;
        put_varint(&p, version);
    }
    if (type_len) {
        *p++ = 0x12;
        put_varint(&p, type_len);
        memcpy(p, type, type_len);
        p += type_len;
    }
    *p++ = 0x32;
    put_varint(&p, inner);
    for (long i = 0; i < n; i++) {
        *p++ = 0x0a;
        put_varint(&p, sub_lens[i]);
        memcpy(p, subs[i], sub_lens[i]);
        p += sub_lens[i];
    }
    return (long)(p - out);
}

// fastscan — native watch-frame scanner for the event hot loop (the port's
// own copy of the JAX package's native/fastscan.cpp).
//
// The watcher's hot path (SURVEY.md §3.1: one iteration per cluster pod
// event, forever) is dominated by JSON-decoding pod objects that the
// TpuResourceFilter then throws away: in a real cluster most pods request no
// accelerator. This scanner reads a raw watch frame
// ({"type":"...","object":{...}}) WITHOUT parsing it and answers the three
// questions the Python layer needs to decide whether a full json.loads is
// necessary at all:
//
//   1. the event "type" (ADDED/MODIFIED/DELETED/BOOKMARK/ERROR),
//   2. the object's metadata.resourceVersion (so a skipped frame still
//      advances the watch resume point),
//   3. whether the accelerator resource key (e.g. "google.com/tpu") appears
//      anywhere in the frame — if the quoted key is absent, the pod cannot
//      be requesting the resource and the frame can be dropped unparsed.
//
// Deliberately conservative: any structural surprise (escapes in the value,
// missing fields) returns a "cannot tell" verdict and the caller falls back
// to the full JSON path. C ABI only — loaded via ctypes (no pybind11).
//
// Assumptions (documented in scanner.py and enforced by fallback-on-doubt):
// the first `"resourceVersion"` in a serialized k8s object is the
// metadata's own (Go's encoding/json emits struct fields in declaration
// order: ObjectMeta precedes Spec/Status, and managedFields — the only
// other resourceVersion carrier — sits inside metadata after it).

#ifndef _GNU_SOURCE
#define _GNU_SOURCE  // memmem
#endif
#include <cstddef>
#include <cstring>

namespace {

// Find the first occurrence of needle (quoted JSON string token) in buf.
// glibc memmem is SIMD-accelerated; anchoring a byte search on '"' would
// stall on every quote in the frame.
inline const char* find_token(const char* buf, size_t len, const char* needle, size_t nlen) {
    if (nlen == 0 || len < nlen) return nullptr;
    return static_cast<const char*>(memmem(buf, len, needle, nlen));
}

// After a `"key"` token: skip whitespace, expect ':', skip whitespace,
// expect '"', then copy the string value into out (cap includes NUL).
// Returns 0 on success, -1 on structural surprise (escape, overflow, EOF).
int read_quoted_value(const char* p, const char* end, char* out, long cap) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end || *p != ':') return -1;
    ++p;
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end || *p != '"') return -1;
    ++p;
    long i = 0;
    while (p < end && *p != '"') {
        if (*p == '\\') return -1;  // escaped value: let Python parse it
        if (i + 1 >= cap) return -1;
        out[i++] = *p++;
    }
    if (p >= end) return -1;
    out[i] = '\0';
    return 0;
}

// CRC-32 (IEEE 802.3, the zlib/crc32 polynomial) over the uid bytes — MUST
// match Python's zlib.crc32 exactly, because the shard verdict computed here
// has to agree with watch/sharded.py shard_of() (a disagreement would make
// the native prefilter drop frames the Python partition owns). The table is
// a C++11 magic static (constructor-initialized): concurrent first calls
// from N shard pump threads get a thread-safe one-time init — a hand-rolled
// `static bool ready` flag here would be a data race.
struct Crc32Table {
    unsigned int t[256];
    Crc32Table() {
        for (unsigned int i = 0; i < 256; ++i) {
            unsigned int c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            t[i] = c;
        }
    }
};

unsigned int crc32_ieee(const char* data, long len) {
    static const Crc32Table table;  // thread-safe magic-static init
    unsigned int crc = 0xFFFFFFFFu;
    for (long i = 0; i < len; ++i)
        crc = table.t[(crc ^ static_cast<unsigned char>(data[i])) & 0xFFu] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

// Scan one watch frame.
//   type_out / rv_out: NUL-terminated outputs ("" = not found).
// Returns a flag bitmask (>= 0) or -1 if the frame is not even a JSON
// object; callers treat any missing piece as "full-parse this frame".
//   bit 0: resource key present somewhere in the frame
//   bit 1: type extracted
//   bit 2: resourceVersion extracted
int fastscan_frame(const char* buf, long len,
                   const char* key, long key_len,
                   char* type_out, long type_cap,
                   char* rv_out, long rv_cap) {
    if (buf == nullptr || len <= 0) return -1;
    const char* end = buf + len;
    const char* p = buf;
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end || *p != '{') return -1;

    int flags = 0;
    if (type_cap > 0) type_out[0] = '\0';
    if (rv_cap > 0) rv_out[0] = '\0';

    // 1. event type: first `"type"` token (the WatchEvent struct's first
    //    field; searched, not assumed, so reordered frames still work)
    static const char kType[] = "\"type\"";
    const char* t = find_token(p, end - p, kType, sizeof(kType) - 1);
    if (t != nullptr &&
        read_quoted_value(t + sizeof(kType) - 1, end, type_out, type_cap) == 0) {
        flags |= 2;
    }

    // 2. resume point: first `"resourceVersion"` token
    static const char kRv[] = "\"resourceVersion\"";
    const char* r = find_token(p, end - p, kRv, sizeof(kRv) - 1);
    if (r != nullptr &&
        read_quoted_value(r + sizeof(kRv) - 1, end, rv_out, rv_cap) == 0) {
        flags |= 4;
    }

    // 3. accelerator key: quoted substring anywhere (conservative — a hit
    //    in a label/annotation just means we full-parse; only a miss allows
    //    skipping, and a miss is exact because resources.requests/limits
    //    keys are serialized as plain quoted strings)
    if (key != nullptr && key_len > 0) {
        if (find_token(p, end - p, key, key_len) != nullptr) flags |= 1;
    }
    return flags;
}

// ---------------------------------------------------------------------------
// Chunk API: split a raw HTTP-chunk buffer into newline-delimited frames and
// scan each one in a single native call. ctypes call overhead (~µs) is paid
// once per chunk instead of once per frame — the difference between the
// native path losing and winning against CPython's C-accelerated regexes.

typedef struct {
    long start;     // frame offset in buf
    long len;       // frame length (trailing \r / \n excluded)
    long count;     // frames this record stands for (skip-runs coalesce)
    int flags;      // fastscan_frame bitmask, or -1 (not a JSON object)
    char type[32];
    char rv[96];
} FastScanRec;

// Returns the number of records written (<= cap); *consumed is set to the
// offset just past the last processed complete frame — the caller keeps
// buf[*consumed:] as the tail for the next chunk. Empty lines are consumed
// without a record. When more than `cap` frames are present the caller
// simply calls again with the unconsumed remainder.
//
// shard/shards: the caller's uid-hash partition (watch/sharded.py). With
// shards > 1, a frame whose first `"uid"` value hashes (crc32 % shards) to
// ANOTHER shard is skippable (bit 3) even when the resource key is present
// — the owning shard's stream will deliver it; this stream only needs the
// resourceVersion. A uid that cannot be extracted cleanly (escape, missing,
// overflow) yields no shard verdict and the frame full-parses — the watch
// source's post-parse ownership filter keeps the partition correct. Pass
// shards <= 1 to disable.
long fastscan_chunk(const char* buf, long len,
                    const char* key, long key_len,
                    long shard, long shards,
                    FastScanRec* out, long cap, long* consumed) {
    static const char kUid[] = "\"uid\"";
    char uid_buf[128];
    long n = 0;
    long pos = 0;
    *consumed = 0;
    while (pos < len && n < cap) {
        const char* nl = static_cast<const char*>(
            memchr(buf + pos, '\n', len - pos));
        if (nl == nullptr) break;  // incomplete frame: leave as tail
        long frame_len = nl - (buf + pos);
        if (frame_len > 0 && buf[pos + frame_len - 1] == '\r') --frame_len;
        if (frame_len > 0) {
            FastScanRec* rec = &out[n];
            rec->start = pos;
            rec->len = frame_len;
            rec->count = 1;
            rec->flags = fastscan_frame(buf + pos, frame_len, key, key_len,
                                        rec->type, sizeof(rec->type),
                                        rec->rv, sizeof(rec->rv));
            // bit 3: frame is skippable — type+rv extracted, no key, and the
            // type is a plain pod event (never ERROR/BOOKMARK). Computed
            // here so Python's per-frame work for a skipped frame is one
            // flag test instead of object construction.
            if (rec->flags >= 0 && (rec->flags & 6) == 6 && !(rec->flags & 1)) {
                const char* t = rec->type;
                if (strcmp(t, "ADDED") == 0 || strcmp(t, "MODIFIED") == 0 ||
                    strcmp(t, "DELETED") == 0) {
                    rec->flags |= 8;
                }
            }
            // foreign-shard skip: key presence does NOT matter here — the
            // owning shard's stream delivers the event; this one only needs
            // the resume point. Gated on the same type+rv extraction the
            // key skip needs (rv-only treatment must still advance resume).
            if (shards > 1 && rec->flags >= 0 && (rec->flags & 6) == 6 &&
                !(rec->flags & 8)) {
                const char* t = rec->type;
                if (strcmp(t, "ADDED") == 0 || strcmp(t, "MODIFIED") == 0 ||
                    strcmp(t, "DELETED") == 0) {
                    const char* u = find_token(buf + pos, frame_len, kUid,
                                               sizeof(kUid) - 1);
                    if (u != nullptr &&
                        read_quoted_value(u + sizeof(kUid) - 1,
                                          buf + pos + frame_len,
                                          uid_buf, sizeof(uid_buf)) == 0 &&
                        uid_buf[0] != '\0') {
                        long owner = crc32_ieee(uid_buf,
                                                strlen(uid_buf)) % shards;
                        if (owner != shard) rec->flags |= 8;
                    }
                }
            }
            // coalesce a run of skippable frames into the previous record:
            // only the run's LAST resourceVersion matters for resume (rv is
            // monotonic), so a non-TPU event storm costs Python one record
            // NB: both flags must be tested >= 0 first — flags == -1 has
            // every bit set, so `-1 & 8` alone would swallow malformed
            // frames into the skip run with a stale rv
            if (rec->flags >= 0 && (rec->flags & 8) && n > 0 &&
                out[n - 1].flags >= 0 && (out[n - 1].flags & 8)) {
                FastScanRec* prev = &out[n - 1];
                memcpy(prev->rv, rec->rv, sizeof(prev->rv));
                prev->count += 1;
                prev->len = (pos + frame_len) - prev->start;
            } else {
                ++n;
            }
        }
        pos = (nl - buf) + 1;
        *consumed = pos;
    }
    return n;
}

}  // extern "C"

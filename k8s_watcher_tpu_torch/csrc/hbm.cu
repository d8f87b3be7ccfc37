// HBM probe kernels for Hopper (sm_90a), behind a plain C interface.
//
// Three kernels, one per Pallas kernel of k8s_watcher_tpu/probe/hbm.py:
//
//   read_sweep_kernel + column_total_kernel  <- _reduce_kernel   (hbm.py:74)
//   fill_kernel                               <- _fill_kernel     (hbm.py:107)
//   blocksum_kernel                           <- _blocksum_kernel (hbm.py:117)
//
// All three are bound by device-memory bytes: each does one add (or none)
// per 4 bytes moved, far below the ~295 operations per byte at which an H100
// stops being memory-bound. So the design is about the bytes alone:
//
// - every access is a 16-byte vector (float4), neighbouring threads on
//   neighbouring addresses, so each warp moves whole 512-byte segments;
// - every access is a streaming access (ld.global.cs / st.global.cs,
//   "evict first") in `asm volatile`: the probe buffers (256 MiB at the
//   defaults) are 5x the 50 MB L2, and a pass must read or write HBM, not
//   lines a previous pass left in L2. `volatile` also keeps the compiler from
//   merging the identical stores of repeated fill passes or folding repeated
//   read passes: each pass is real traffic, as on the TPU;
// - the `repeats` passes loop inside one launch (the TPU kernels' sequential
//   grid axis), so one launch moves ~32 GiB and the host fence is noise.
//
// The TPU grid runs in order and _reduce_kernel's `out_ref[:] +=` relies on
// it. CTAs run in parallel here, so the read sweep writes one (WIDTH,)
// partial per CTA and a second small kernel sums the partials. Every sum is
// of integer-valued floats below 2^24, so the result does not depend on the
// order of the adds.
//
// Every entry point returns cudaGetLastError() after its launches; the
// Python wrapper raises on a non-zero code.
//
// Timing: the read sweep and the fill take an optional pair of CUDA events
// (`start`, `end`: made by the caller and kept across calls). The call records
// `start` before its launches and `end` after them on the same stream, and
// returns without waiting, so the caller can queue the next launch behind this
// one and read the time between the two events once the stream has passed
// `end`: a start event queued behind running work opens when that work ends,
// so each reading is one launch's device time. k8w_time_graph launches a
// captured CUDA graph (the probe's GEMM chain, a collective) between events
// of its own, waits for the second and returns the time. Launches and events
// leave in one C call, so no host delay can fall between them: the probe
// shares its Python process with the watcher's ingest threads, and a window
// opened from Python also timed the probe thread's waits for the interpreter
// lock. The graph's window also opens behind a gate (see k8w_time_graph),
// since a sub-millisecond graph would otherwise time its own submission.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int READ_WIDTH = 512;                      // f32 columns of the read buffer
constexpr int READ_VECS_PER_ROW = READ_WIDTH / 4;    // 128 float4 per row
constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_ROWS_PER_STEP = SWEEP_THREADS / READ_VECS_PER_ROW;  // 2
constexpr int SWEEP_UNROLL = 4;

// one write block is 512 x 256 f32 = 512 KiB = 2^15 float4
constexpr int WRITE_BLOCK_VECS_LOG2 = 15;
constexpr int WRITE_BLOCK_VECS = 1 << WRITE_BLOCK_VECS_LOG2;
constexpr int FILL_THREADS = 256;
constexpr int FILL_UNROLL = 4;
constexpr int BLOCKSUM_THREADS = 256;
constexpr int BLOCKSUM_UNROLL = 4;

__device__ __forceinline__ float4 load_stream(const float4* p) {
    float4 v;
    asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
    return v;
}

__device__ __forceinline__ void store_stream(float4* p, float4 v) {
    asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};"
                 :
                 : "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
}

// Each CTA walks row pairs with a grid stride, `repeats` times over the whole
// buffer; thread t of a row owns columns 4(t % 128) .. +3. The two sub-rows
// of the CTA are folded in shared memory into one (READ_WIDTH,) partial.
__global__ void __launch_bounds__(SWEEP_THREADS)
read_sweep_kernel(const float4* __restrict__ x, long long rows, int repeats,
                  float4* __restrict__ partials) {
    const int col4 = threadIdx.x % READ_VECS_PER_ROW;
    const int sub = threadIdx.x / READ_VECS_PER_ROW;
    const long long stride = (long long)gridDim.x * SWEEP_ROWS_PER_STEP;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < repeats; ++r) {
        long long row = (long long)blockIdx.x * SWEEP_ROWS_PER_STEP + sub;
        for (; row + (SWEEP_UNROLL - 1) * stride < rows; row += SWEEP_UNROLL * stride) {
            float4 v[SWEEP_UNROLL];
#pragma unroll
            for (int u = 0; u < SWEEP_UNROLL; ++u)
                v[u] = load_stream(x + (row + u * stride) * READ_VECS_PER_ROW + col4);
#pragma unroll
            for (int u = 0; u < SWEEP_UNROLL; ++u) add4(acc, v[u]);
        }
        for (; row < rows; row += stride)
            add4(acc, load_stream(x + row * READ_VECS_PER_ROW + col4));
    }
    __shared__ float4 fold[SWEEP_THREADS];
    fold[threadIdx.x] = acc;
    __syncthreads();
    if (sub == 0) {
        float4 s = fold[col4];
#pragma unroll
        for (int k = 1; k < SWEEP_ROWS_PER_STEP; ++k) add4(s, fold[k * READ_VECS_PER_ROW + col4]);
        partials[(long long)blockIdx.x * READ_VECS_PER_ROW + col4] = s;
    }
}

// out[c] = sum over CTAs of partials[cta][c]: one thread per column.
__global__ void column_total_kernel(const float* __restrict__ partials, int num_parts,
                                    float* __restrict__ out) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= READ_WIDTH) return;
    float s = 0.f;
    for (int p = 0; p < num_parts; ++p) s += partials[(long long)p * READ_WIDTH + c];
    out[c] = s;
}

// Flat grid stride over float4 q; q belongs to write block q >> 15, stamped
// (block + 1) + seed. The seed is read from device memory at run time.
__global__ void __launch_bounds__(FILL_THREADS)
fill_kernel(const float* __restrict__ seed, float4* __restrict__ out, long long n_vecs,
            int repeats) {
    const float s = *seed;
    const long long stride = (long long)gridDim.x * FILL_THREADS;
    const long long first = (long long)blockIdx.x * FILL_THREADS + threadIdx.x;
    for (int r = 0; r < repeats; ++r) {
        long long q = first;
        for (; q + (FILL_UNROLL - 1) * stride < n_vecs; q += FILL_UNROLL * stride) {
#pragma unroll
            for (int u = 0; u < FILL_UNROLL; ++u) {
                const long long i = q + u * stride;
                const float v = (float)((i >> WRITE_BLOCK_VECS_LOG2) + 1) + s;
                store_stream(out + i, make_float4(v, v, v, v));
            }
        }
        for (; q < n_vecs; q += stride) {
            const float v = (float)((q >> WRITE_BLOCK_VECS_LOG2) + 1) + s;
            store_stream(out + q, make_float4(v, v, v, v));
        }
    }
}

// One CTA per write block: strided float4 loads into independent
// accumulators, then a warp-shuffle and shared-memory tree into out[block].
__global__ void __launch_bounds__(BLOCKSUM_THREADS)
blocksum_kernel(const float4* __restrict__ x, float* __restrict__ out) {
    const float4* blk = x + (long long)blockIdx.x * WRITE_BLOCK_VECS;
    float acc[BLOCKSUM_UNROLL] = {0.f, 0.f, 0.f, 0.f};
    for (int q = threadIdx.x; q < WRITE_BLOCK_VECS; q += BLOCKSUM_UNROLL * BLOCKSUM_THREADS) {
        float4 v[BLOCKSUM_UNROLL];
#pragma unroll
        for (int u = 0; u < BLOCKSUM_UNROLL; ++u) v[u] = load_stream(blk + q + u * BLOCKSUM_THREADS);
#pragma unroll
        for (int u = 0; u < BLOCKSUM_UNROLL; ++u) acc[u] += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
    float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    __shared__ float warp_sums[BLOCKSUM_THREADS / 32];
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    if (lane == 0) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
        s = lane < BLOCKSUM_THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) out[blockIdx.x] = s;
    }
}

static_assert(WRITE_BLOCK_VECS % (BLOCKSUM_UNROLL * BLOCKSUM_THREADS) == 0,
              "blocksum loop assumes whole unrolled strides per block");

constexpr unsigned long long GATE_LIMIT_NS = 50ull * 1000 * 1000;  // 50 ms

// Spins until the host sets *open (host-mapped memory), or GATE_LIMIT_NS
// pass on the device clock: the gate of k8w_time_graph.
__global__ void gate_kernel(const volatile int* open) {
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    do {
        if (*open) return;
        __nanosleep(1000);
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    } while (t - t0 < GATE_LIMIT_NS);
}

// The device-time window of k8w_time_graph (`ms` null: untimed).
struct Window {
    cudaEvent_t start = nullptr;
    cudaEvent_t end = nullptr;

    ~Window() {
        if (start) cudaEventDestroy(start);
        if (end) cudaEventDestroy(end);
    }

    cudaError_t open(float* ms, cudaStream_t s) {
        if (!ms) return cudaSuccess;
        cudaError_t e = cudaEventCreate(&start);
        if (e == cudaSuccess) e = cudaEventCreate(&end);
        if (e == cudaSuccess) e = cudaEventRecord(start, s);
        return e;
    }

    // after the launches and the end event's record: their error first, else
    // the window's
    cudaError_t close(float* ms) {
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess || !ms) return e;
        e = cudaEventSynchronize(end);
        if (e == cudaSuccess) e = cudaEventElapsedTime(ms, start, end);
        return e;
    }
};

// Records `event` on `s` where it is not null: a self-timed launch's start or
// end (see "Timing" above).
cudaError_t mark(void* event, cudaStream_t s) {
    return event ? cudaEventRecord(static_cast<cudaEvent_t>(event), s) : cudaSuccess;
}

}  // namespace

extern "C" {

// x: (rows, 512) f32; partials: (num_ctas, 512) f32 scratch; out: (1, 512) f32.
int k8w_hbm_read_sweep(const float* x, long long rows, int repeats, float* partials,
                       int num_ctas, float* out, void* stream, void* start, void* end) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = mark(start, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    read_sweep_kernel<<<num_ctas, SWEEP_THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(x), rows, repeats, reinterpret_cast<float4*>(partials));
    column_total_kernel<<<(READ_WIDTH + 127) / 128, 128, 0, s>>>(partials, num_ctas, out);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = mark(end, s);
    return static_cast<int>(e);
}

// seed: 1 f32 on the device; out: n_elems f32, n_elems a multiple of 4.
int k8w_hbm_fill(const float* seed, float* out, long long n_elems, int repeats, int num_ctas,
                 void* stream, void* start, void* end) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = mark(start, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    fill_kernel<<<num_ctas, FILL_THREADS, 0, s>>>(seed, reinterpret_cast<float4*>(out), n_elems / 4, repeats);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = mark(end, s);
    return static_cast<int>(e);
}

// One launch of an instantiated CUDA graph, timed (elapsed_ms required),
// after one untimed launch of `before_exec` where it is not null. The window
// opens behind a gate: a one-thread kernel holds the stream until the host
// has queued `before_exec`, the start event, the graph and the end event (or
// GATE_LIMIT_NS pass), so the window times the graph and not the host's
// submission of it, which stretches when the host's cores are contended. A
// collective's `before_exec` is a barrier over its members (one tiny
// collective), so the window also leaves out the wait for the slowest
// member's host to open its own gate.
int k8w_time_graph(void* graph_exec, void* before_exec, void* stream, float* elapsed_ms) {
    static thread_local int* gate = nullptr;  // host-mapped flag, one per timing thread
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaSuccess;
    if (!gate) e = cudaHostAlloc(reinterpret_cast<void**>(&gate), sizeof(int), cudaHostAllocMapped);
    int* gate_dev = nullptr;
    if (e == cudaSuccess) e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&gate_dev), gate, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    __atomic_store_n(gate, 0, __ATOMIC_SEQ_CST);
    gate_kernel<<<1, 1, 0, s>>>(gate_dev);
    Window w;
    e = cudaGetLastError();
    if (e == cudaSuccess && before_exec) e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(before_exec), s);
    if (e == cudaSuccess) e = w.open(elapsed_ms, s);
    if (e == cudaSuccess) e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(graph_exec), s);
    if (e == cudaSuccess && elapsed_ms) e = cudaEventRecord(w.end, s);
    __atomic_store_n(gate, 1, __ATOMIC_SEQ_CST);  // open the gate on every path
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(w.close(elapsed_ms));
}

// x: num_blocks write blocks of 512 x 256 f32; out: num_blocks f32.
int k8w_hbm_blocksums(const float* x, int num_blocks, float* out, void* stream) {
    blocksum_kernel<<<num_blocks, BLOCKSUM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), out);
    return static_cast<int>(cudaGetLastError());
}

const char* k8w_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

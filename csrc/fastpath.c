/* gt4py_tpu native runtime helpers.
 *
 * The reference's native layer is generated C++ bound with pybind11
 * (pyext_builder.py); here the compute path is XLA on the GPU, and the native
 * runtime pieces that remain host-side are implemented here and bound via
 * ctypes (no pybind11 dependency):
 *
 *  - 64-byte-aligned host buffer allocation for staging arrays
 *    (counterpart of storage/allocators.py:330 NDArrayBufferAllocator's
 *    over-allocate+offset scheme, done natively),
 *  - FNV-1a content hashing for stencil fingerprints / cache keys
 *    (counterpart of eve/utils.py content_hash on the hot path).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(_WIN32)
#define EXPORT __declspec(dllexport)
#else
#define EXPORT __attribute__((visibility("default")))
#endif

EXPORT uint64_t gt_fnv1a64(const unsigned char *data, size_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; ++i) {
        h ^= (uint64_t)data[i];
        h *= 1099511628211ULL;
    }
    return h;
}

/* Combine an existing hash with new data (for incremental cache keys). */
EXPORT uint64_t gt_fnv1a64_combine(uint64_t h, const unsigned char *data, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        h ^= (uint64_t)data[i];
        h *= 1099511628211ULL;
    }
    return h;
}

EXPORT void *gt_aligned_alloc(size_t nbytes, size_t alignment) {
    void *ptr = NULL;
    if (alignment < sizeof(void *)) alignment = sizeof(void *);
    /* alignment must be a power of two */
    if ((alignment & (alignment - 1)) != 0) return NULL;
    size_t rounded = (nbytes + alignment - 1) / alignment * alignment;
    if (posix_memalign(&ptr, alignment, rounded) != 0) return NULL;
    return ptr;
}

EXPORT void gt_free(void *ptr) { free(ptr); }

/* Fast memset/copy for buffer initialization (avoids numpy overhead for
 * small staging buffers). */
EXPORT void gt_fill_zero(void *ptr, size_t nbytes) { memset(ptr, 0, nbytes); }

/* Minimal declarations of the zstd API used by native/*.cc, for hosts that
 * ship the runtime library (libzstd.so.1) without its development header.
 * Signatures are those of the stable zstd ABI (zstd.h, v1.x).  Link with
 * -l:libzstd.so.1. */
#ifndef EBCC_COMPAT_ZSTD_H
#define EBCC_COMPAT_ZSTD_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);
const char* ZSTD_getErrorName(size_t code);

#ifdef __cplusplus
}
#endif

#endif /* EBCC_COMPAT_ZSTD_H */

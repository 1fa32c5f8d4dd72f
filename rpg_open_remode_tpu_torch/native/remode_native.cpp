// Native IO runtime for rpg_open_remode_tpu_torch: the port's own copy of
// rpg_open_remode_tpu/native/remode_native.cpp (host IO, not a device kernel).
//
// The reference implements its host runtime in C++ (test/dataset.cpp,
// src/publisher.cpp). The one path here that is hot on the host and slow in
// Python is the ASCII ground-truth depthmap parse (test/dataset.cpp:159-186:
// W*H whitespace-separated floats, centimetres on disk / 100 -> metres). A
// 640x480 file is ~2.5 MB of text per frame; the strtof loop parses it
// ~5x faster than the numpy version's split, and without the GIL, so the
// dataset prefetcher's thread does not hold up the frame loop
// (chip_smoke.py's host IO timing on the H100 machine's host, PERF.md).
//
// The JAX package's copy also writes PLY and decodes PGM. The port does
// both with numpy: in the same timing the native PLY writer was no faster
// and the native PGM reader was slower.
//
// Built as a plain shared library (g++ -O3 -shared -fPIC), loaded with
// ctypes; its numpy version with the same semantics is in
// rpg_open_remode_tpu_torch/native/__init__.py.

#include <cstdio>
#include <cstdlib>

extern "C" {

// Parse `count` whitespace-separated floats from the file, scaling by
// `scale` (the dataset stores centimetres; pass 0.01f to get metres —
// matching the /100 in test/dataset.cpp:180). Returns the number parsed.
long rmd_parse_float_file(const char *path, float *out, long count, float scale)
{
    FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char *buf = (char *)std::malloc(size + 1);
    if (!buf) { std::fclose(f); return -1; }
    long got = (long)std::fread(buf, 1, size, f);
    std::fclose(f);
    buf[got] = '\0';

    long n = 0;
    char *p = buf;
    char *end = buf + got;
    while (n < count && p < end) {
        char *next = nullptr;
        float v = std::strtof(p, &next);
        if (next == p) { ++p; continue; }  // skip non-numeric byte
        out[n++] = v * scale;
        p = next;
    }
    std::free(buf);
    return n;
}

}  // extern "C"

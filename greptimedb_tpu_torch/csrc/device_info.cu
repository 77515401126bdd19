// Device facts the host reads through ctypes (no kernel here).
//
// gtpu_device_peak_bytes_per_s: the card's peak memory rate, from the
// card itself: 2 (double data rate) x memory clock x bus width. The
// roofline accountant (utils/roofline.py) divides a statement's
// achieved bytes per second by it.

#include <cuda_runtime.h>

extern "C" int gtpu_device_peak_bytes_per_s(int device, double* out) {
    int clock_khz = 0;
    int bus_bits = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&clock_khz, cudaDevAttrMemoryClockRate, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&bus_bits, cudaDevAttrGlobalMemoryBusWidth,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    *out = 2.0 * static_cast<double>(clock_khz) * 1000.0 *
           (static_cast<double>(bus_bits) / 8.0);
    return 0;
}

// window_layout.h built for the host: the planner (ops/window.py) loads it
// with ctypes; the kernel's own build includes the same header.

#include "window_layout.h"

extern "C" size_t window_layout_bytes(int T, int B, int n, int E, int K,
                                      int S, int wc, int mode) {
  return S < 1 ? 0 : layout_bytes(T, B, n, E, K, S, wc, mode);
}

extern "C" int window_layout_slice_width(int K, int S) {
  return S < 1 ? 0 : slice_width(K, S);
}

extern "C" size_t window_layout_grid_exchange_words(int B, int n, int E,
                                                    int K, int wc, int S) {
  return S < 1 || wc < 1 ? 0 : grid_exchange_words(B, n, E, K, wc, S);
}

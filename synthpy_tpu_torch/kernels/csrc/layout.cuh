// The channel layout of a field's packed values, shared by K4
// (slab_march.cu), K5 (time_march.cu) and K6 (adaptive.cu): the three
// accelerations, then the optional inverse-bremsstrahlung (kappa), phase
// and three Faraday channels, as fields/domain.py ChannelLayout orders
// them, and the dispatch of a kernel templated on it.

#pragma once

namespace layouts {

template <int IB, int PS, int BON>
struct Layout {
  static constexpr int C = 3 + IB + PS + 3 * BON;
  static constexpr int KI = 3;
  static constexpr int PI = 3 + IB;
  static constexpr int FI = 3 + IB + PS;
  static constexpr bool inv_brems = IB, phaseshift = PS, B_on = BON;
};

// Dispatch a functor templated on the layout from its three switches.
template <template <class> class F, class... A>
void with_layout(int inv_brems, int phaseshift, int B_on, A&&... args) {
  switch (inv_brems | (phaseshift << 1) | (B_on << 2)) {
    case 0: F<Layout<0, 0, 0>>::run(args...); break;
    case 1: F<Layout<1, 0, 0>>::run(args...); break;
    case 2: F<Layout<0, 1, 0>>::run(args...); break;
    case 3: F<Layout<1, 1, 0>>::run(args...); break;
    case 4: F<Layout<0, 0, 1>>::run(args...); break;
    case 5: F<Layout<1, 0, 1>>::run(args...); break;
    case 6: F<Layout<0, 1, 1>>::run(args...); break;
    default: F<Layout<1, 1, 1>>::run(args...); break;
  }
}

}  // namespace layouts

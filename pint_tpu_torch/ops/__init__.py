"""Device numeric primitives: double-double arithmetic (``dd``),
Taylor/Horner evaluation (``taylor``), the host numpy twins (``dd_np``),
and the hand-written CUDA kernels with their plain versions
(``z2_harmonics``)."""

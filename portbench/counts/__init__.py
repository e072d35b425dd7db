"""Operations and bytes: one module a kernel (``k1`` ... ``k6``), one a
model (the defined products a step, for ``mfu.*``). Each counts what any
implementation of its work needs, from the shapes alone: a product of an
[n, k] and a [k, m] matrix is 2·n·k·m operations; each input byte is read
once and each output byte written once; recomputed work is not counted."""

"""The plain reference of the benchmark: the block-sparse product over X's
pattern (``operator``), the library's tfQMR (``tfqmr``), and the judge that
decides ``correct`` (``judge``).  Plain torch and numpy: it imports nothing
of the program and nothing of JAX, and it takes only the inputs that the
benchmark made, and the program's outputs to judge them."""

"""Plain references, one file a model family, named by a configuration's
``reference`` key: ``logits(m, w, seqs, precision)``. They import nothing
of the program under test."""

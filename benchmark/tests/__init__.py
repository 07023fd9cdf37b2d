"""CPU tests of the benchmark (and, marked ``gpu``, its runs on a card)."""

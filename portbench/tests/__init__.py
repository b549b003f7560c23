'''CPU tests of the benchmark (python -m pytest portbench/tests -q); the
tests marked cuda run on the card and skip here.'''

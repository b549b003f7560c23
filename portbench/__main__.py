'''python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>'''

import time

_T0 = time.time()

if __name__ == '__main__':
    import sys

    from portbench.run import main

    sys.exit(main(sys.argv[1:], t0=_T0))

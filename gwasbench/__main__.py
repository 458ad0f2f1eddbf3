import time

# set-up is timed from here, before torch and the program are imported
_T0 = time.perf_counter()

if __name__ == '__main__':
    from gwasbench.run import main
    raise SystemExit(main(t0=_T0))

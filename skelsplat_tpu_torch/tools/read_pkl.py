#!/usr/bin/env python
"""Pickle inspection helper (counterpart of
``skelsplat_tpu/tools/read_pkl.py``)."""

import argparse
import pickle


def read_pkl(file_path):
    with open(file_path, "rb") as f:
        while True:
            try:
                return pickle.load(f)
            except EOFError:
                break


def main(argv=None):
    parser = argparse.ArgumentParser(description="Read a pickle file.")
    parser.add_argument("--file_path", required=True)
    args = parser.parse_args(argv)
    data = read_pkl(args.file_path)
    print(type(data))
    if isinstance(data, dict):
        print(list(data.keys()))
    else:
        print(data)


if __name__ == "__main__":
    main()

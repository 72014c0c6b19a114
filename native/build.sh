#!/bin/sh
# Build the native PLY codec -> native/build/libsplatply.so (the same build
# splatapult_jax/io/native.py runs at first use).
set -e
cd "$(dirname "$0")"
mkdir -p build
g++ -O3 -shared -fPIC -pthread -std=c++17 -o build/libsplatply.so splatply.cpp
echo "built native/build/libsplatply.so"

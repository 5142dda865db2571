#!/bin/sh
# Build the native host components.
set -e
cd "$(dirname "$0")"
g++ -O3 -shared -fPIC -o libsge_native.so bvh_builder.cpp
echo "built native/libsge_native.so"

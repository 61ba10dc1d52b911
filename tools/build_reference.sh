#!/bin/bash
# Build the reference m2dec decoder binaries (the bit-exactness oracle and
# the single-core fps baseline denominator; see BASELINE.md).
# Reference tree (read-only) is expected at /root/reference.
# Outputs: build/ref/h264dec, build/ref/m2dec
set -e
REF=${REF:-/root/reference}
OUT=${OUT:-$(dirname "$0")/../build/ref}
mkdir -p "$OUT"
cd "$OUT"
printf '#define HAVE_CONFIG_H 1\n' > config.h
# System-getopt shim (the bundled my_getopt conflicts with glibc declarations).
printf '#ifndef SHIM_GETOPT_H\n#define SHIM_GETOPT_H\n#include <unistd.h>\n#include_next <getopt.h>\n#endif\n' > getopt.h
# App sources are copied next to the shim so that #include "getopt.h" resolves here.
cp "$REF"/src/app/{h264dec.cpp,m2dec.cpp,md5.c,md5.h,m2decoder.h,frames.h,filewrite.h,display.h,display.cpp,optparser.h,module.h,module.cpp,unithread.h} .
LIB="$REF/src/lib"
CORE="$LIB/bitio.c $LIB/m2d.cpp $LIB/mpeg2.cpp $LIB/idct.cpp $LIB/motioncomp.cpp $LIB/mpeg_demux.cpp $LIB/txt2bin.c"
g++ -O2 -w -DNDEBUG -DUNIT_TEST -I. -I"$LIB" -o h264dec h264dec.cpp md5.c \
    $CORE "$LIB/h264.cpp" "$LIB/h265.cpp" "$LIB/h265_x86.cpp"
g++ -O2 -w -DNDEBUG -DUNIT_TEST -I. -I"$LIB" -o m2dec m2dec.cpp display.cpp md5.c $CORE
# HD-capacity variant for the 1080p MPEG-2 bench denominator: the stock
# m2dec app statically sizes its frame heap for 720x576 (m2dec.cpp
# WIDTH/HEIGHT) and SEGFAULTS on 1080p input —
# patch only the capacity constants (decode logic identical).
sed 's/const int WIDTH = 720;/const int WIDTH = 1920;/; s/const int HEIGHT = 576;/const int HEIGHT = 1088;/; s/1920 \* 1080/1920 * 1088/' \
    m2dec.cpp > m2dec_hd.cpp
g++ -O2 -w -DNDEBUG -DUNIT_TEST -I. -I"$LIB" -o m2dec_hd m2dec_hd.cpp display.cpp md5.c $CORE
echo "built: $OUT/h264dec $OUT/m2dec $OUT/m2dec_hd"
# FAST_DECODE (--enable-fastdec) variant: DC-only 1/8-scale decode oracle.
g++ -O2 -w -DNDEBUG -DUNIT_TEST -DFAST_DECODE '-Dsint16_t=int16_t' -I. -I"$LIB" -o h264dec_fast \
    h264dec.cpp md5.c $CORE "$LIB/h264.cpp" "$LIB/h265.cpp" "$LIB/h265_x86.cpp"
g++ -O2 -w -DNDEBUG -DUNIT_TEST -DFAST_DECODE '-Dsint16_t=int16_t' -I. -I"$LIB" -o m2dec_fast \
    m2dec.cpp display.cpp md5.c $CORE
echo "built: $OUT/h264dec_fast $OUT/m2dec_fast"

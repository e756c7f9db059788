/* Copy of firedancer_tpu/tango/native/fdt_sha512.c, kept in the port so that
   firedancer_tpu_torch builds its ring library from its own sources. */

/* Host-side SHA-512 for the verify tile's Ed25519 k-digest.

   Why it exists: the accelerator rides behind a narrow host<->device
   transfer path, and shipping whole messages to the device costs far
   more bytes than shipping their 64-byte digests.  The
   verify k = SHA512(R || A || M) is therefore computed on the host inside
   fdt_verify_expand's one GIL-released pass, and the device prologue
   starts from the digest (ops/ed25519/verify.verify_batch_digest).

   The round-constant table is injected at load time by the Python
   binding (utils/shaconst.py derives it from prime cube roots) — the
   algorithm here is plain FIPS 180-4 compression, written fresh. */

#include <stdint.h>
#include <string.h>

static uint64_t SHA512_K[ 80 ];
static uint64_t SHA512_H0[ 8 ];

void fdt_sha512_init_consts( uint64_t const * k80, uint64_t const * h8 ) {
  memcpy( SHA512_K, k80, sizeof( SHA512_K ) );
  memcpy( SHA512_H0, h8, sizeof( SHA512_H0 ) );
}

static inline uint64_t ror64( uint64_t x, int n ) {
  return ( x >> n ) | ( x << ( 64 - n ) );
}

static inline uint64_t be64( uint8_t const * p ) {
  uint64_t v = 0;
  for( int i = 0; i < 8; i++ ) v = ( v << 8 ) | p[ i ];
  return v;
}

static void sha512_compress( uint64_t st[ 8 ], uint8_t const blk[ 128 ] ) {
  uint64_t w[ 80 ];
  for( int t = 0; t < 16; t++ ) w[ t ] = be64( blk + 8 * t );
  for( int t = 16; t < 80; t++ ) {
    uint64_t s0 = ror64( w[ t - 15 ], 1 ) ^ ror64( w[ t - 15 ], 8 ) ^ ( w[ t - 15 ] >> 7 );
    uint64_t s1 = ror64( w[ t - 2 ], 19 ) ^ ror64( w[ t - 2 ], 61 ) ^ ( w[ t - 2 ] >> 6 );
    w[ t ] = w[ t - 16 ] + s0 + w[ t - 7 ] + s1;
  }
  uint64_t a = st[ 0 ], b = st[ 1 ], c = st[ 2 ], d = st[ 3 ];
  uint64_t e = st[ 4 ], f = st[ 5 ], g = st[ 6 ], h = st[ 7 ];
  for( int t = 0; t < 80; t++ ) {
    uint64_t S1 = ror64( e, 14 ) ^ ror64( e, 18 ) ^ ror64( e, 41 );
    uint64_t ch = ( e & f ) ^ ( ~e & g );
    uint64_t t1 = h + S1 + ch + SHA512_K[ t ] + w[ t ];
    uint64_t S0 = ror64( a, 28 ) ^ ror64( a, 34 ) ^ ror64( a, 39 );
    uint64_t mj = ( a & b ) ^ ( a & c ) ^ ( b & c );
    uint64_t t2 = S0 + mj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[ 0 ] += a; st[ 1 ] += b; st[ 2 ] += c; st[ 3 ] += d;
  st[ 4 ] += e; st[ 5 ] += f; st[ 6 ] += g; st[ 7 ] += h;
}

/* digest of (r[32] || a[32] || m[mlen]) -> out[64] */
void fdt_sha512_rpm( uint8_t const * r, uint8_t const * a,
                     uint8_t const * m, uint64_t mlen, uint8_t * out ) {
  uint64_t st[ 8 ];
  memcpy( st, SHA512_H0, sizeof( st ) );
  uint8_t buf[ 128 ];
  memcpy( buf, r, 32 );
  memcpy( buf + 32, a, 32 );
  uint64_t fill = 64;
  uint8_t const * p = m;
  uint64_t left = mlen;
  while( fill + left >= 128 ) {
    uint64_t take = 128 - fill;
    memcpy( buf + fill, p, take );
    sha512_compress( st, buf );
    p += take; left -= take; fill = 0;
  }
  memcpy( buf + fill, p, left );
  fill += left;
  buf[ fill++ ] = 0x80;
  if( fill > 112 ) {
    memset( buf + fill, 0, 128 - fill );
    sha512_compress( st, buf );
    fill = 0;
  }
  memset( buf + fill, 0, 120 - fill );
  uint64_t bits = ( 64 + mlen ) * 8;
  for( int i = 0; i < 8; i++ ) buf[ 120 + i ] = (uint8_t)( bits >> ( 56 - 8 * i ) );
  sha512_compress( st, buf );
  for( int i = 0; i < 8; i++ )
    for( int j = 0; j < 8; j++ )
      out[ 8 * i + j ] = (uint8_t)( st[ i ] >> ( 56 - 8 * j ) );
}

/* standalone batch API (tests; store-side uses) */
void fdt_sha512_batch( uint8_t const * msgs, int32_t const * lens,
                       uint64_t n, uint64_t width, uint8_t * out ) {
  static uint8_t const zero[ 64 ] = { 0 };
  (void)zero;
  for( uint64_t i = 0; i < n; i++ ) {
    /* whole-message digest: reuse the rpm core with an empty prefix by
       hashing m directly */
    uint64_t st[ 8 ];
    memcpy( st, SHA512_H0, sizeof( st ) );
    uint8_t buf[ 128 ];
    uint8_t const * m = msgs + i * width;
    uint64_t left = (uint64_t)lens[ i ];
    while( left >= 128 ) {
      sha512_compress( st, m );
      m += 128; left -= 128;
    }
    memcpy( buf, m, left );
    uint64_t fill = left;
    buf[ fill++ ] = 0x80;
    if( fill > 112 ) {
      memset( buf + fill, 0, 128 - fill );
      sha512_compress( st, buf );
      fill = 0;
    }
    memset( buf + fill, 0, 120 - fill );
    uint64_t bits = (uint64_t)lens[ i ] * 8;
    for( int b = 0; b < 8; b++ )
      buf[ 120 + b ] = (uint8_t)( bits >> ( 56 - 8 * b ) );
    sha512_compress( st, buf );
    uint8_t * o = out + i * 64;
    for( int a2 = 0; a2 < 8; a2++ )
      for( int j = 0; j < 8; j++ )
        o[ 8 * a2 + j ] = (uint8_t)( st[ a2 ] >> ( 56 - 8 * j ) );
  }
}

/* ==== XXH64 (zstd content checksums; spec-derived prime constants) ==== */

static const uint64_t XP1 = 0x9E3779B185EBCA87ULL;
static const uint64_t XP2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t XP3 = 0x165667B19E3779F9ULL;
static const uint64_t XP4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t XP5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t xrotl( uint64_t x, int r ) {
  return ( x << r ) | ( x >> ( 64 - r ) );
}

static inline uint64_t xread64( uint8_t const * p ) {
  uint64_t v;
  memcpy( &v, p, 8 );
  return v;  /* little-endian hosts only (matches the rest of the build) */
}

uint64_t fdt_xxh64( uint8_t const * p, uint64_t n, uint64_t seed ) {
  uint8_t const * end = p + n;
  uint64_t h;
  if( n >= 32 ) {
    uint64_t v1 = seed + XP1 + XP2, v2 = seed + XP2, v3 = seed,
             v4 = seed - XP1;
    uint8_t const * limit = end - 32;
    do {
      v1 = xrotl( v1 + xread64( p ) * XP2, 31 ) * XP1; p += 8;
      v2 = xrotl( v2 + xread64( p ) * XP2, 31 ) * XP1; p += 8;
      v3 = xrotl( v3 + xread64( p ) * XP2, 31 ) * XP1; p += 8;
      v4 = xrotl( v4 + xread64( p ) * XP2, 31 ) * XP1; p += 8;
    } while( p <= limit );
    h = xrotl( v1, 1 ) + xrotl( v2, 7 ) + xrotl( v3, 12 ) + xrotl( v4, 18 );
    v1 = xrotl( v1 * XP2, 31 ) * XP1; h = ( h ^ v1 ) * XP1 + XP4;
    v2 = xrotl( v2 * XP2, 31 ) * XP1; h = ( h ^ v2 ) * XP1 + XP4;
    v3 = xrotl( v3 * XP2, 31 ) * XP1; h = ( h ^ v3 ) * XP1 + XP4;
    v4 = xrotl( v4 * XP2, 31 ) * XP1; h = ( h ^ v4 ) * XP1 + XP4;
  } else {
    h = seed + XP5;
  }
  h += n;
  while( p + 8 <= end ) {
    h = xrotl( h ^ ( xrotl( xread64( p ) * XP2, 31 ) * XP1 ), 27 ) * XP1 + XP4;
    p += 8;
  }
  if( p + 4 <= end ) {
    uint32_t v;
    memcpy( &v, p, 4 );
    h = xrotl( h ^ ( (uint64_t)v * XP1 ), 23 ) * XP2 + XP3;
    p += 4;
  }
  while( p < end ) {
    h = xrotl( h ^ ( (uint64_t)*p * XP5 ), 11 ) * XP1;
    p++;
  }
  h ^= h >> 33; h *= XP2; h ^= h >> 29; h *= XP3; h ^= h >> 32;
  return h;
}

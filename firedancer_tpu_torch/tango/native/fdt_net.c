/* fdt_net.c — the port's copy of firedancer_tpu/tango/native/fdt_net.c,
   with the burst UDP I/O of the JAX package's fdt_pack.c
   (fdt_udp_recv_burst, fdt_udp_send_burst) moved in beside it.  See
   fdt_net.h for the design notes.  Original implementation: tiles/net.py's
   two directions restated over recvmmsg/sendmmsg, publishing through the
   stem's shared out-block helpers.  -Werror keeps the mmsg usage honest
   under -std=c11 via _GNU_SOURCE. */

#define _GNU_SOURCE
#include "fdt_net.h"

#include "fdt_stem.h"
#include "fdt_tango.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <string.h>
#include <sys/socket.h>

#define MMSG_MAX 1024

static inline uint32_t le32( uint8_t const * p ) {
  return (uint32_t)p[ 0 ] | ( (uint32_t)p[ 1 ] << 8 ) |
         ( (uint32_t)p[ 2 ] << 16 ) | ( (uint32_t)p[ 3 ] << 24 );
}

/* ==== burst UDP I/O ===================================================== */

int64_t fdt_udp_recv_burst( int fd, uint8_t * rows, int64_t stride,
                            uint32_t * szs, int64_t max_pkts, int64_t mtu ) {
  struct mmsghdr msgs[ MMSG_MAX ];
  struct iovec iovs[ MMSG_MAX ];
  struct sockaddr_in addrs[ MMSG_MAX ];
  int64_t total = 0;
  while( total < max_pkts ) {
    int64_t want = max_pkts - total;
    if( want > MMSG_MAX ) want = MMSG_MAX;
    for( int64_t i = 0; i < want; i++ ) {
      iovs[ i ].iov_base = rows + ( total + i ) * stride + 6;
      iovs[ i ].iov_len = (size_t)( mtu - 6 );
      memset( &msgs[ i ].msg_hdr, 0, sizeof( struct msghdr ) );
      msgs[ i ].msg_hdr.msg_iov = &iovs[ i ];
      msgs[ i ].msg_hdr.msg_iovlen = 1;
      msgs[ i ].msg_hdr.msg_name = &addrs[ i ];
      msgs[ i ].msg_hdr.msg_namelen = sizeof( struct sockaddr_in );
    }
    /* MSG_TRUNC: msg_len reports the REAL datagram length even past
       the iov budget, so callers can meter oversize drops instead of
       silently forwarding a truncated packet (tiles/net.py parity) */
    int got = recvmmsg( fd, msgs, (unsigned)want,
                        MSG_DONTWAIT | MSG_TRUNC, 0 );
    if( got <= 0 ) break;
    for( int i = 0; i < got; i++ ) {
      uint8_t * row = rows + ( total + i ) * stride;
      memcpy( row, &addrs[ i ].sin_addr.s_addr, 4 );
      uint16_t port = ntohs( addrs[ i ].sin_port );
      row[ 4 ] = (uint8_t)port;
      row[ 5 ] = (uint8_t)( port >> 8 );
      szs[ total + i ] = 6U + msgs[ i ].msg_len;
    }
    total += got;
    if( got < (int)want ) break;
  }
  return total;
}

int64_t fdt_udp_send_burst( int fd, uint8_t const * rows, int64_t stride,
                            uint32_t const * szs, int64_t n,
                            uint8_t const * addrs ) {
  struct mmsghdr msgs[ MMSG_MAX ];
  struct iovec iovs[ MMSG_MAX ];
  struct sockaddr_in sa[ MMSG_MAX ];
  int64_t total = 0;
  while( total < n ) {
    int64_t want = n - total;
    if( want > MMSG_MAX ) want = MMSG_MAX;
    for( int64_t i = 0; i < want; i++ ) {
      uint8_t const * row = rows + ( total + i ) * stride;
      uint8_t const * a = addrs ? addrs : row;
      int64_t off = addrs ? 0 : 6;
      sa[ i ].sin_family = AF_INET;
      memcpy( &sa[ i ].sin_addr.s_addr, a, 4 );
      sa[ i ].sin_port = htons( (uint16_t)( a[ 4 ] | ( a[ 5 ] << 8 ) ) );
      memset( sa[ i ].sin_zero, 0, sizeof( sa[ i ].sin_zero ) );
      iovs[ i ].iov_base = (void *)( row + off );
      iovs[ i ].iov_len = (size_t)( (int64_t)szs[ total + i ] - off );
      memset( &msgs[ i ].msg_hdr, 0, sizeof( struct msghdr ) );
      msgs[ i ].msg_hdr.msg_iov = &iovs[ i ];
      msgs[ i ].msg_hdr.msg_iovlen = 1;
      msgs[ i ].msg_hdr.msg_name = &sa[ i ];
      msgs[ i ].msg_hdr.msg_namelen = sizeof( struct sockaddr_in );
    }
    int sent = sendmmsg( fd, msgs, (unsigned)want, MSG_DONTWAIT );
    if( sent <= 0 ) break;
    total += sent;
    if( sent < (int)want ) break;
  }
  return total;
}

/* route cache probe: returns 0 empty / 1 unrouted / 2 routed */
static int rc_get( uint64_t * args, uint32_t ip ) {
  int64_t * w = (int64_t *)args[ FDT_NET_A_WORDS ];
  uint32_t const * keys = (uint32_t const *)args[ FDT_NET_A_RC_KEYS ];
  uint8_t const * vals = (uint8_t const *)args[ FDT_NET_A_RC_VALS ];
  uint64_t mask = (uint64_t)w[ FDT_NET_W_RC_MASK ];
  uint64_t i = ( ip * 0x9E3779B1UL ) & mask;
  for( uint64_t probe = 0; probe <= mask; probe++ ) {
    uint64_t s = ( i + probe ) & mask;
    if( !vals[ s ] ) return 0;
    if( keys[ s ] == ip ) return vals[ s ];
  }
  return 0;
}

void fdt_net_route_put( uint64_t * args, uint32_t ip, int64_t routed ) {
  int64_t * w = (int64_t *)args[ FDT_NET_A_WORDS ];
  uint32_t * keys = (uint32_t *)args[ FDT_NET_A_RC_KEYS ];
  uint8_t * vals = (uint8_t *)args[ FDT_NET_A_RC_VALS ];
  uint64_t mask = (uint64_t)w[ FDT_NET_W_RC_MASK ];
  uint64_t i = ( ip * 0x9E3779B1UL ) & mask;
  for( uint64_t probe = 0; probe <= mask; probe++ ) {
    uint64_t s = ( i + probe ) & mask;
    if( !vals[ s ] ) {
      keys[ s ] = ip;
      vals[ s ] = routed ? 2 : 1;
      w[ FDT_NET_W_RC_CNT ]++;
      return;
    }
    if( keys[ s ] == ip ) return; /* already classified */
  }
}

int64_t fdt_net_tx( uint64_t * args, uint8_t const * in_dc,
                    void const * frags, int64_t n, uint64_t * ctrs ) {
  int64_t * w = (int64_t *)args[ FDT_NET_A_WORDS ];
  fdt_frag_t const * f = (fdt_frag_t const *)frags;
  int fd = (int)w[ FDT_NET_W_TX_FD ];

  /* classify first: the send below must only cover frags whose route
     verdict the cache already knows — the first unknown destination
     hands the tail back to Python (lookup + fdt_net_route_put) */
  int64_t k = n;
  int miss = 0;
  for( int64_t i = 0; i < n; i++ ) {
    uint8_t const * row = in_dc + (uint64_t)f[ i ].chunk * FDT_CHUNK_SZ;
    if( !rc_get( args, le32( row ) ) ) {
      k = i;
      miss = 1;
      break;
    }
  }
  if( k > 0 ) {
    struct mmsghdr msgs[ MMSG_MAX ];
    struct iovec iovs[ MMSG_MAX ];
    struct sockaddr_in sa[ MMSG_MAX ];
    int64_t total = 0;
    while( total < k ) {
      int64_t want = k - total;
      if( want > MMSG_MAX ) want = MMSG_MAX;
      for( int64_t i = 0; i < want; i++ ) {
        uint8_t const * row =
            in_dc + (uint64_t)f[ total + i ].chunk * FDT_CHUNK_SZ;
        sa[ i ].sin_family = AF_INET;
        memcpy( &sa[ i ].sin_addr.s_addr, row, 4 );
        sa[ i ].sin_port =
            htons( (uint16_t)( row[ 4 ] | ( row[ 5 ] << 8 ) ) );
        memset( sa[ i ].sin_zero, 0, sizeof( sa[ i ].sin_zero ) );
        iovs[ i ].iov_base = (void *)( row + 6 );
        /* clamp: a malformed frag with sz < 6 must not underflow the
           iov length to ~2^64 (the 6-byte prefix read above is always
           in-bounds — dcache rows are chunk-granular) */
        iovs[ i ].iov_len =
            f[ total + i ].sz >= 6
                ? (size_t)( f[ total + i ].sz - 6 )
                : 0;
        memset( &msgs[ i ].msg_hdr, 0, sizeof( struct msghdr ) );
        msgs[ i ].msg_hdr.msg_iov = &iovs[ i ];
        msgs[ i ].msg_hdr.msg_iovlen = 1;
        msgs[ i ].msg_hdr.msg_name = &sa[ i ];
        msgs[ i ].msg_hdr.msg_namelen = sizeof( struct sockaddr_in );
      }
      int sent = sendmmsg( fd, msgs, (unsigned)want, MSG_DONTWAIT );
      if( sent <= 0 ) break;
      total += sent;
      if( sent < (int)want ) break;
    }
    /* route classification covers only packets actually SENT (the
       tiles/net.py invariant: tx_routed + tx_unrouted == tx_dgrams
       across partial EAGAIN bursts); tx_bytes covers the whole
       handled run, sent or dropped, like the Python loop's */
    uint64_t bytes = 0;
    for( int64_t i = 0; i < k; i++ )
      bytes += f[ i ].sz >= 6 ? (uint64_t)f[ i ].sz - 6UL : 0UL;
    for( int64_t i = 0; i < total; i++ ) {
      uint8_t const * row =
          in_dc + (uint64_t)f[ i ].chunk * FDT_CHUNK_SZ;
      if( rc_get( args, le32( row ) ) == 2 ) ctrs[ FDT_NET_C_ROUTED ]++;
      else ctrs[ FDT_NET_C_UNROUTED ]++;
    }
    ctrs[ FDT_NET_C_TX_DGRAMS ] += (uint64_t)total;
    ctrs[ FDT_NET_C_TX_BYTES ] += bytes;
  }
  return miss ? ~k : k;
}

int64_t fdt_net_rx( uint64_t * args, uint64_t * outs, int64_t n_outs,
                    int64_t sig_cap, uint64_t tspub, uint64_t * ctrs ) {
  (void)n_outs;
  int64_t * w = (int64_t *)args[ FDT_NET_A_WORDS ];
  uint32_t * szs = (uint32_t *)args[ FDT_NET_A_SZS ];
  uint64_t * ob = outs; /* rx ring = outs[0] */
  uint8_t * dc = (uint8_t *)ob[ FDT_STEM_O_DCACHE ];
  uint64_t * cur = (uint64_t *)ob[ FDT_STEM_O_CHUNKP ];
  int64_t mtu = w[ FDT_NET_W_MTU ];
  int64_t burst = w[ FDT_NET_W_BURST ];
  int64_t stride_chunks = ( mtu + (int64_t)FDT_CHUNK_SZ - 1 ) /
                          (int64_t)FDT_CHUNK_SZ;
  int64_t stride = stride_chunks * (int64_t)FDT_CHUNK_SZ;
  int64_t wmark = (int64_t)ob[ FDT_STEM_O_WMARK ];

  int64_t published = 0;
  uint64_t sig = 0;
  int fds[ 2 ] = { (int)w[ FDT_NET_W_QUIC_FD ],
                   (int)w[ FDT_NET_W_UDP_FD ] };
  uint16_t ctls[ 2 ] = { FDT_NET_CTL_QUIC, FDT_NET_CTL_LEGACY };
  for( int s = 0; s < 2; s++ ) {
    int64_t want = burst;
    while( want > 0 ) {
      /* live credit re-read every recvmmsg round: fdt_stem_out_cr
         reads the producer seq (already advanced by this sweep's own
         emits) against fresh consumer fseqs, so a pre-sweep snapshot
         can never go stale across the burst's back-edges
         (shm-stale-credit) */
      int64_t cr = fdt_stem_out_cr( ob );
      int64_t take = want < cr ? want : cr;
      if( take <= 0 ) break;
      /* reserve mtu-stride rows at the cursor; wrap when fewer than
         one stride fits before the watermark (the compact-ring rule,
         applied at full-MTU granularity so recvmmsg can write every
         row of the burst in ONE syscall) */
      int64_t c = (int64_t)*cur;
      if( c + stride_chunks > wmark ) c = 0;
      int64_t room = ( wmark - c ) / stride_chunks;
      int64_t batch = take < room ? take : room;
      if( batch > MMSG_MAX ) batch = MMSG_MAX;
      if( batch <= 0 ) break;
      int64_t got = fdt_udp_recv_burst(
          fds[ s ], dc + c * (int64_t)FDT_CHUNK_SZ, stride, szs, batch,
          mtu );
      if( got <= 0 ) break;
      int64_t w_idx = 0; /* kept-row write position */
      for( int64_t i = 0; i < got; i++ ) {
        if( (int64_t)szs[ i ] > mtu ) {
          /* MSG_TRUNC: datagram larger than the payload budget —
             metered drop.  The dropped row's reservation is RECLAIMED
             (later kept rows compact down) so a flood of oversize
             datagrams can never advance the cursor without consuming
             credits and lap payloads of published-but-unconsumed
             frags.  (The Python loop drops before building a row, so
             only this path had reservations to reclaim.) */
          ctrs[ FDT_NET_C_OVERSIZE ]++;
          continue;
        }
        if( w_idx != i )
          memcpy( dc + ( c + w_idx * stride_chunks ) *
                           (int64_t)FDT_CHUNK_SZ,
                  dc + ( c + i * stride_chunks ) *
                           (int64_t)FDT_CHUNK_SZ,
                  (uint64_t)szs[ i ] );
        /* the shared emit body (ring-publish order + sig scratch +
           in-burst trace): the payload is already in place, so the
           chunk-addressed variant publishes without a copy */
        fdt_stem_out_emit_at(
            ob, sig, (uint32_t)( c + w_idx * stride_chunks ),
            (uint64_t)szs[ i ],
            (uint16_t)( ctls[ s ] | FDT_CTL_SOM | FDT_CTL_EOM ),
            (uint32_t)tspub, (uint32_t)tspub, sig_cap );
        sig++;
        published++;
        w_idx++;
        ctrs[ FDT_NET_C_RX_DGRAMS ]++;
        ctrs[ FDT_NET_C_RX_BYTES ] += (uint64_t)szs[ i ] - 6UL;
      }
      *cur = (uint64_t)( c + w_idx * stride_chunks );
      want -= got;
      if( got < batch ) break;
    }
  }
  return published;
}

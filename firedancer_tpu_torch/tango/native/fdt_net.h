/* fdt_net.h — native net-tile datagram paths.
 *
 * The port's copy of firedancer_tpu/tango/native/fdt_net.h, with the burst
 * UDP I/O (fdt_udp_recv_burst, fdt_udp_send_burst) that the JAX package
 * keeps in fdt_pack.c/.h: here it lives beside its only users, the net
 * paths below and the QUIC tile's direct-socket egress.
 *
 * Reference model (behavior contract; implementation original):
 * src/app/fdctl/run/tiles/fd_net.c + src/waltz/ — the only tile
 * touching the NIC moves packets in BURSTS (AF_XDP rings there; one
 * recvmmsg/sendmmsg syscall per burst here), never a per-packet
 * interpreter hop.  This build's NetTile did one Python socket call
 * plus one np.zeros row build per datagram; these entry points restate
 * both directions over the fdt_udp_*_burst syscalls:
 *
 *   fdt_udp_recv_burst / fdt_udp_send_burst — one recvmmsg / sendmmsg
 *     per up-to-1024 datagrams over rows of 6-byte addr prefix + payload.
 *   fdt_net_tx — the on_frags path (tx ring): sendmmsg a drained run
 *     of addr-prefixed datagram frags with the iovecs pointing
 *     STRAIGHT INTO the in dcache (zero copy).  Egress route
 *     classification (tx_routed/tx_unrouted — the fd_ip mirror) reads
 *     a native route cache; a destination not yet cached hands the
 *     frag back to Python, which does the IpStack lookup and inserts
 *     it via fdt_net_route_put — the bank-tile MISS -> resolve ->
 *     retry pattern, so steady state is zero Python per packet.
 *   fdt_net_rx — the after-credit hook: recvmmsg bursts from both
 *     sockets (QUIC + legacy ports) with the iovecs writing
 *     addr-prefixed rows DIRECTLY INTO the out dcache at reserved
 *     chunk-cursor positions, then publish the metas — credit-gated
 *     per burst against the live consumer fseqs.  Oversize datagrams
 *     (MSG_TRUNC) are metered drops, published never.
 */

#ifndef FDT_NET_H
#define FDT_NET_H

#include <stdint.h>

/* args block u64 word indices (built by NetTile.native_handler) */
#define FDT_NET_A_WORDS 0   /* i64[8]: see FDT_NET_W_* */
#define FDT_NET_A_RC_KEYS 1 /* u32[rc_cap] route-cache keys (ipv4) */
#define FDT_NET_A_RC_VALS 2 /* u8[rc_cap]: 0 empty, 1 unrouted, 2 routed */
#define FDT_NET_A_SZS 3     /* u32[burst] recv size scratch */

#define FDT_NET_W_TX_FD 0
#define FDT_NET_W_QUIC_FD 1
#define FDT_NET_W_UDP_FD 2
#define FDT_NET_W_BURST 3
#define FDT_NET_W_MTU 4     /* NET_MTU: 6-byte addr prefix + payload */
#define FDT_NET_W_RC_MASK 5 /* rc_cap - 1 (power of two) */
#define FDT_NET_W_RC_CNT 6  /* live entries (Python enforces the cap) */

/* ctl tags, shared with tiles/net.py (CTL_QUIC / CTL_LEGACY) */
#define FDT_NET_CTL_QUIC 8
#define FDT_NET_CTL_LEGACY 16

/* ctrs indices (NetTile.native_handler maps these to counters) */
#define FDT_NET_C_RX_DGRAMS 0
#define FDT_NET_C_TX_DGRAMS 1
#define FDT_NET_C_RX_BYTES 2
#define FDT_NET_C_TX_BYTES 3
#define FDT_NET_C_OVERSIZE 4
#define FDT_NET_C_ROUTED 5
#define FDT_NET_C_UNROUTED 6

/* ==== burst UDP I/O ====================================================
 *
 * Rows of `stride` bytes: a 6-byte address prefix (ipv4 + little-endian
 * port) then the payload.  recv writes up to max_pkts rows and each row's
 * size (6 + the datagram's REAL length: MSG_TRUNC, so a size past mtu
 * marks an oversize datagram whose tail was cut); returns rows written.
 * send takes the destination from `addrs` (6 bytes per row) when given,
 * else from each row's prefix; returns datagrams sent (EAGAIN stops it). */
int64_t fdt_udp_recv_burst( int fd, uint8_t * rows, int64_t stride,
                            uint32_t * szs, int64_t max_pkts, int64_t mtu );
int64_t fdt_udp_send_burst( int fd, uint8_t const * rows, int64_t stride,
                            uint32_t const * szs, int64_t n,
                            uint8_t const * addrs );

/* tx: returns frags fully handled, or ~k when frag k's destination is
   not in the route cache (Python resolves + fdt_net_route_put). */
int64_t fdt_net_tx( uint64_t * args, uint8_t const * in_dc,
                    void const * frags, int64_t n, uint64_t * ctrs );

/* rx after-credit hook: returns datagrams published. */
int64_t fdt_net_rx( uint64_t * args, uint64_t * outs, int64_t n_outs,
                    int64_t sig_cap, uint64_t tspub, uint64_t * ctrs );

/* Insert one route-classification result (called from the Python slow
   path after an IpStack lookup; plain store, single-writer tile). */
void fdt_net_route_put( uint64_t * args, uint32_t ip, int64_t routed );

#endif /* FDT_NET_H */

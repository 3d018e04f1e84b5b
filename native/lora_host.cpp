// Native host runtime for the JAX LoRa framework.
//
// The device (through JAX) owns the DSP compute path; this library owns the
// host-side runtime the reference implements in C/C++: AES-128 + CMAC for
// LoRaWAN MIC (reference: src/lorawan/aes.c vendored tiny-AES-c +
// src/lorawan/lorawan.cpp:15-98), the byte-level codec fast path
// (Hamming(8,4), SX1272 CRC-16, whitening — include/lora_phy/LoRaCodes.hpp),
// and float32 IQ file IO for the CLI runners.
//
// Implemented from the public algorithm specifications (FIPS-197, RFC 4493,
// Semtech AN1200.18) — no code is copied from the reference; AES tables are
// computed at init from GF(2^8) arithmetic rather than embedded.
//
// Exposed as a flat C ABI consumed via ctypes (native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstdio>

extern "C" {

// ---------------------------------------------------------------------------
// AES-128 (FIPS-197), ECB single-block encrypt — tables computed at startup
// ---------------------------------------------------------------------------

static uint8_t SBOX[256];
static bool sbox_ready = false;

static uint8_t gf_mul(uint8_t a, uint8_t b) {
    uint8_t p = 0;
    while (b) {
        if (b & 1) p ^= a;
        uint8_t hi = a & 0x80;
        a <<= 1;
        if (hi) a ^= 0x1B;  // AES irreducible polynomial x^8+x^4+x^3+x+1
        b >>= 1;
    }
    return p;
}

static void build_sbox() {
    // multiplicative inverse in GF(2^8) followed by the affine transform
    uint8_t inv[256];
    inv[0] = 0;
    for (int a = 1; a < 256; ++a) {
        for (int b = 1; b < 256; ++b) {
            if (gf_mul((uint8_t)a, (uint8_t)b) == 1) { inv[a] = (uint8_t)b; break; }
        }
    }
    for (int i = 0; i < 256; ++i) {
        uint8_t x = inv[i], y = x;
        for (int r = 0; r < 4; ++r) {
            y = (uint8_t)((y << 1) | (y >> 7));
            x ^= y;
        }
        SBOX[i] = x ^ 0x63;
    }
    sbox_ready = true;
}

struct AesKey {
    uint8_t rk[11][16];
};

static void aes_expand_key(const uint8_t key[16], AesKey* ks) {
    if (!sbox_ready) build_sbox();
    std::memcpy(ks->rk[0], key, 16);
    uint8_t rcon = 1;
    for (int r = 1; r <= 10; ++r) {
        const uint8_t* prev = ks->rk[r - 1];
        uint8_t* out = ks->rk[r];
        uint8_t t[4] = {SBOX[prev[13]], SBOX[prev[14]], SBOX[prev[15]], SBOX[prev[12]]};
        t[0] ^= rcon;
        rcon = gf_mul(rcon, 2);
        for (int i = 0; i < 4; ++i) out[i] = prev[i] ^ t[i];
        for (int i = 4; i < 16; ++i) out[i] = prev[i] ^ out[i - 4];
    }
}

static void aes_encrypt_block(const AesKey* ks, uint8_t s[16]) {
    for (int i = 0; i < 16; ++i) s[i] ^= ks->rk[0][i];
    for (int round = 1; round <= 10; ++round) {
        // SubBytes
        for (int i = 0; i < 16; ++i) s[i] = SBOX[s[i]];
        // ShiftRows (column-major state: s[r + 4c])
        uint8_t t[16];
        for (int c = 0; c < 4; ++c)
            for (int r = 0; r < 4; ++r)
                t[r + 4 * c] = s[r + 4 * ((c + r) & 3)];
        std::memcpy(s, t, 16);
        // MixColumns (skipped in the last round)
        if (round != 10) {
            for (int c = 0; c < 4; ++c) {
                uint8_t* col = s + 4 * c;
                uint8_t a0 = col[0], a1 = col[1], a2 = col[2], a3 = col[3];
                col[0] = gf_mul(a0, 2) ^ gf_mul(a1, 3) ^ a2 ^ a3;
                col[1] = a0 ^ gf_mul(a1, 2) ^ gf_mul(a2, 3) ^ a3;
                col[2] = a0 ^ a1 ^ gf_mul(a2, 2) ^ gf_mul(a3, 3);
                col[3] = gf_mul(a0, 3) ^ a1 ^ a2 ^ gf_mul(a3, 2);
            }
        }
        for (int i = 0; i < 16; ++i) s[i] ^= ks->rk[round][i];
    }
}

void lora_aes128_ecb_encrypt(const uint8_t key[16], uint8_t block[16]) {
    AesKey ks;
    aes_expand_key(key, &ks);
    aes_encrypt_block(&ks, block);
}

// ---------------------------------------------------------------------------
// AES-CMAC (RFC 4493) and the LoRaWAN B0-block MIC (lorawan.cpp:35-98)
// ---------------------------------------------------------------------------

static void shift_left_128(const uint8_t* in, uint8_t* out) {
    uint8_t carry = 0;
    for (int i = 15; i >= 0; --i) {
        out[i] = (uint8_t)((in[i] << 1) | carry);
        carry = (in[i] & 0x80) ? 1 : 0;
    }
}

void lora_cmac(const uint8_t key[16], const uint8_t* msg, uint64_t len,
               uint8_t mac_out[16]) {
    AesKey ks;
    aes_expand_key(key, &ks);
    uint8_t L[16] = {0}, k1[16], k2[16];
    aes_encrypt_block(&ks, L);
    shift_left_128(L, k1);
    if (L[0] & 0x80) k1[15] ^= 0x87;
    shift_left_128(k1, k2);
    if (k1[0] & 0x80) k2[15] ^= 0x87;

    uint64_t n = (len + 15) / 16;
    bool complete = (n != 0) && (len % 16 == 0);
    if (n == 0) n = 1;

    uint8_t x[16] = {0}, blk[16];
    for (uint64_t i = 0; i + 1 < n; ++i) {
        for (int j = 0; j < 16; ++j) blk[j] = msg[i * 16 + j] ^ x[j];
        aes_encrypt_block(&ks, blk);
        std::memcpy(x, blk, 16);
    }
    uint8_t last[16] = {0};
    uint64_t off = (n - 1) * 16;
    uint64_t rem = len - off;
    for (uint64_t j = 0; j < rem; ++j) last[j] = msg[off + j];
    if (complete) {
        for (int j = 0; j < 16; ++j) last[j] ^= k1[j];
    } else {
        last[rem] = 0x80;
        for (int j = 0; j < 16; ++j) last[j] ^= k2[j];
    }
    for (int j = 0; j < 16; ++j) last[j] ^= x[j];
    aes_encrypt_block(&ks, last);
    std::memcpy(mac_out, last, 16);
}

uint32_t lora_wan_mic(const uint8_t key[16], int uplink, uint32_t devaddr,
                      uint32_t fcnt, const uint8_t* data, uint64_t len) {
    // B0 block layout per LoRaWAN 1.0 (lorawan.cpp:46-58)
    uint8_t buf[16 + 4096];
    if (len > 4096) return 0;
    uint8_t* b0 = buf;
    std::memset(b0, 0, 16);
    b0[0] = 0x49;
    b0[5] = uplink ? 0 : 1;
    b0[6] = (uint8_t)(devaddr & 0xFF);
    b0[7] = (uint8_t)((devaddr >> 8) & 0xFF);
    b0[8] = (uint8_t)((devaddr >> 16) & 0xFF);
    b0[9] = (uint8_t)((devaddr >> 24) & 0xFF);
    b0[10] = (uint8_t)(fcnt & 0xFF);
    b0[11] = (uint8_t)((fcnt >> 8) & 0xFF);
    b0[12] = (uint8_t)((fcnt >> 16) & 0xFF);
    b0[13] = (uint8_t)((fcnt >> 24) & 0xFF);
    b0[14] = (uint8_t)((len >> 8) & 0xFF);
    b0[15] = (uint8_t)(len & 0xFF);
    std::memcpy(buf + 16, data, len);
    uint8_t mac[16];
    lora_cmac(key, buf, 16 + len, mac);
    return (uint32_t)mac[0] | ((uint32_t)mac[1] << 8) |
           ((uint32_t)mac[2] << 16) | ((uint32_t)mac[3] << 24);
}

// ---------------------------------------------------------------------------
// Host codec fast path (vectorized-on-host byte transforms)
// ---------------------------------------------------------------------------

static inline uint8_t ham84_enc(uint8_t x) {
    uint8_t d0 = x & 1, d1 = (x >> 1) & 1, d2 = (x >> 2) & 1, d3 = (x >> 3) & 1;
    uint8_t b = x & 0xF;
    b |= (uint8_t)((d0 ^ d1 ^ d2) << 4);
    b |= (uint8_t)((d1 ^ d2 ^ d3) << 5);
    b |= (uint8_t)((d0 ^ d1 ^ d3) << 6);
    b |= (uint8_t)((d0 ^ d2 ^ d3) << 7);
    return b;
}

static uint8_t HAM_DEC[256];
static bool ham_ready = false;

static void build_ham_dec() {
    for (int b = 0; b < 256; ++b) {
        uint8_t b0 = b & 1, b1 = (b >> 1) & 1, b2 = (b >> 2) & 1, b3 = (b >> 3) & 1;
        uint8_t b4 = (b >> 4) & 1, b5 = (b >> 5) & 1, b6 = (b >> 6) & 1, b7 = (b >> 7) & 1;
        uint8_t p = (uint8_t)((b0 ^ b1 ^ b2 ^ b4) | ((b1 ^ b2 ^ b3 ^ b5) << 1) |
                              ((b0 ^ b1 ^ b3 ^ b6) << 2) | ((b0 ^ b2 ^ b3 ^ b7) << 3));
        uint8_t v;
        switch (p) {
            case 0xD: v = (b ^ 1) & 0xF; break;
            case 0x7: v = (b ^ 2) & 0xF; break;
            case 0xB: v = (b ^ 4) & 0xF; break;
            case 0xE: v = (b ^ 8) & 0xF; break;
            default:  v = b & 0xF; break;
        }
        HAM_DEC[b] = v;
    }
    ham_ready = true;
}

void lora_host_encode(const uint8_t* bytes, uint64_t n, uint16_t* symbols) {
    for (uint64_t i = 0; i < n; ++i) {
        symbols[2 * i] = ham84_enc((uint8_t)(bytes[i] >> 4));
        symbols[2 * i + 1] = ham84_enc((uint8_t)(bytes[i] & 0xF));
    }
}

void lora_host_decode(const uint16_t* symbols, uint64_t nsym, uint8_t* bytes) {
    if (!ham_ready) build_ham_dec();
    for (uint64_t i = 0; i + 1 < nsym; i += 2) {
        uint8_t hi = HAM_DEC[symbols[i] & 0xFF] & 0xF;
        uint8_t lo = HAM_DEC[symbols[i + 1] & 0xFF] & 0xF;
        bytes[i / 2] = (uint8_t)((hi << 4) | lo);
    }
}

static inline uint8_t xsum8_c(uint8_t t) {
    t ^= (uint8_t)(t >> 4);
    t ^= (uint8_t)(t >> 2);
    t ^= (uint8_t)(t >> 1);
    return t & 1;
}

uint16_t lora_host_crc(const uint8_t* data, uint64_t n) {
    uint16_t res = 0;
    uint8_t v = 0xFF;
    for (uint64_t i = 0; i < n; ++i) {
        uint16_t crc = res;
        for (int k = 0; k < 8; ++k)
            crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x1021)
                                 : (uint16_t)(crc << 1);
        v = (uint8_t)(xsum8_c(v & 0xB8) | (uint8_t)(v << 1));
        res = (uint16_t)(crc ^ data[i]);
    }
    res ^= v;
    v = (uint8_t)(xsum8_c(v & 0xB8) | (uint8_t)(v << 1));
    res ^= (uint16_t)(v << 8);
    return res;
}

void lora_host_whiten_lfsr(uint8_t* data, uint64_t n, int bit_ofs, int rdd) {
    const uint64_t s1a = 0x6572D100E85C2EFFull, s1b = 0xE85C2EFFFFFFFFFFull;
    const uint64_t s2a = 0x05121100F8ECFEEFull, s2b = 0xF8ECFEEFEFEFEFEFull;
    uint64_t r[2] = {rdd == 1 ? s2a : s1a, rdd == 1 ? s2b : s1b};
    const uint8_t m = (uint8_t)(0xFF >> (4 - rdd));
    int i = 0;
    for (; i < bit_ofs; ++i)
        r[i & 1] = (r[i & 1] >> 8) |
                   (((r[i & 1] >> 32) ^ (r[i & 1] >> 24) ^ (r[i & 1] >> 16) ^ r[i & 1]) << 56);
    for (uint64_t j = 0; j < n; ++j, ++i) {
        data[j] ^= (uint8_t)(r[i & 1] & m);
        r[i & 1] = (r[i & 1] >> 8) |
                   (((r[i & 1] >> 32) ^ (r[i & 1] >> 24) ^ (r[i & 1] >> 16) ^ r[i & 1]) << 56);
    }
}

// ---------------------------------------------------------------------------
// IQ file IO (float32 interleaved pairs, the runner wire format:
// tx_runner.cpp:133-138 / rx_runner.cpp IO)
// ---------------------------------------------------------------------------

int64_t lora_host_read_iq(const char* path, float* out, int64_t cap) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t got = (int64_t)std::fread(out, sizeof(float), (size_t)cap, f);
    std::fclose(f);
    return got;
}

int64_t lora_host_write_iq(const char* path, const float* data, int64_t n) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    int64_t put = (int64_t)std::fwrite(data, sizeof(float), (size_t)n, f);
    std::fclose(f);
    return put;
}

}  // extern "C"

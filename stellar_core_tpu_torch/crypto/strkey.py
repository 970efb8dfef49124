"""StrKey — human-readable key encoding (reference: src/crypto/StrKey.{h,cpp}).

base32(version-byte ‖ payload ‖ CRC16-XMODEM), no padding. Version bytes per
the Stellar strkey spec (StrKey.h enum): G=public, S=seed, T=pre-auth-tx,
X=hash-x, P=signed-payload, M=muxed-account, C=contract.
"""

from __future__ import annotations

import base64


class StrKeyError(ValueError):
    pass


# version byte = enum << 3 (so the first base32 char is the letter)
VER_PUBKEY_ED25519 = 6 << 3       # 'G'
VER_SEED_ED25519 = 18 << 3        # 'S'
VER_PRE_AUTH_TX = 19 << 3         # 'T'
VER_HASH_X = 23 << 3              # 'X'
VER_SIGNED_PAYLOAD = 15 << 3      # 'P'
VER_MUXED_ACCOUNT = 12 << 3       # 'M'
VER_CONTRACT = 2 << 3             # 'C'


def crc16_xmodem(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


class StrKey:
    @staticmethod
    def encode(version: int, payload: bytes) -> str:
        body = bytes([version]) + payload
        crc = crc16_xmodem(body)
        body += crc.to_bytes(2, "little")
        return base64.b32encode(body).decode().rstrip("=")

    @staticmethod
    def decode(expected_version: int, s: str) -> bytes:
        pad = "=" * (-len(s) % 8)
        try:
            body = base64.b32decode(s + pad)
        except Exception as e:
            raise StrKeyError(f"bad base32: {e}")
        if len(body) < 3:
            raise StrKeyError("too short")
        version, payload, crc = body[0], body[1:-2], body[-2:]
        if version != expected_version:
            raise StrKeyError(f"version byte mismatch: {version}")
        if crc16_xmodem(body[:-2]).to_bytes(2, "little") != crc:
            raise StrKeyError("checksum mismatch")
        # round-trip check rejects non-canonical encodings (reference:
        # StrKey.cpp decode verifies re-encode identity)
        if StrKey.encode(version, payload) != s:
            raise StrKeyError("non-canonical strkey")
        return payload

    # convenience wrappers
    @staticmethod
    def encode_ed25519_public(raw32: bytes) -> str:
        return StrKey.encode(VER_PUBKEY_ED25519, raw32)

    @staticmethod
    def decode_ed25519_public(s: str) -> bytes:
        out = StrKey.decode(VER_PUBKEY_ED25519, s)
        if len(out) != 32:
            raise StrKeyError("bad length")
        return out

    @staticmethod
    def encode_ed25519_seed(raw32: bytes) -> str:
        return StrKey.encode(VER_SEED_ED25519, raw32)

    @staticmethod
    def decode_ed25519_seed(s: str) -> bytes:
        out = StrKey.decode(VER_SEED_ED25519, s)
        if len(out) != 32:
            raise StrKeyError("bad length")
        return out

    @staticmethod
    def encode_contract(raw32: bytes) -> str:
        return StrKey.encode(VER_CONTRACT, raw32)

    @staticmethod
    def encode_muxed_account(ed25519_raw: bytes, mux_id: int) -> str:
        """M-address (SEP-23 / CAP-27): 40-byte payload = ed25519 key
        followed by the big-endian 8-byte mux id."""
        return StrKey.encode(VER_MUXED_ACCOUNT,
                             ed25519_raw + mux_id.to_bytes(8, "big"))

    @staticmethod
    def decode_muxed_account(s: str):
        out = StrKey.decode(VER_MUXED_ACCOUNT, s)
        if len(out) != 40:
            raise StrKeyError("bad length")
        return out[:32], int.from_bytes(out[32:], "big")

// The port's lossy WebP decoder: a VP8 key frame as RFC 6386 defines it
// and libwebp 1.6 decodes it (src/dec/vp8_dec.c, tree_dec.c, quant_dec.c,
// frame_dec.c, io_dec.c; src/dsp/dec.c, upsampling.c, yuv.h), into the
// RGBA that WebPDecode gives for MODE_RGBA with default options, which is
// what Pillow's WebPAnimDecoder asks for. No libwebp is linked.
//
//   sfod_webp_vp8_decode  a VP8 chunk's payload (and the ALPH chunk's, if
//                         the frame has one) -> RGB8 [h, w, 3] or RGBA8
//
// The boolean decoder is libwebp's, end of partition included: past its
// last byte a partition reads one zero byte and is flagged, and a frame
// whose first partition or token partition was read that far is refused,
// as libwebp refuses it ("Premature end-of-partition0" / "-of-file").
// Header: colour space and clamping bits, up to 4 segments with map and
// data updates, simple or normal loop filter with level, sharpness and
// the mode/ref deltas, 1-8 token partitions, quantiser indices and deltas,
// coefficient-probability updates and the skip probability. Macroblocks:
// 16x16 DC/TM/V/H (DC without top and/or left at the frame's edges), the
// ten 4x4 modes with libwebp's top-right replication, chroma; tokens with
// their neighbour contexts; libwebp's dequantisation (y2 DC x2, y2 AC
// x155/100 at least 8, UV DC at most 132); the inverse WHT and DCT; the
// simple or normal loop filter, inner edges only where the macroblock is
// 4x4-predicted or has coefficients. Output: fancy upsampling of the 4:2:0
// chroma and the 14-bit fixed-point YUV -> RGB of yuv.h; no dithering.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace sfod_webp {
int alpha_plane(const uint8_t* data, size_t size, int width, int height, uint8_t* out);
}

namespace {

// the error codes (data/native_codec.py names them; -5..-7 are shared with
// webp_vp8l.cpp, whose lossless-stream codes -9 and -10 become -11 and -12
// when the stream is an ALPH plane)
constexpr int kTruncated = -1;
constexpr int kBadHeader = -2;
constexpr int kPartition0End = -3;
constexpr int kTokenEnd = -4;
constexpr int kNoMemory = -5;

// RFC 6386's tables; kBModesProba in libwebp's numbering of the 4x4 modes
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// the default coefficient probabilities [type][band][context][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
         {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
         {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
         {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
         {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
         {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
         {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
         {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
         {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
         {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
         {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
         {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
         {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
         {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
         {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
         {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
         {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
         {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
         {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
         {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
         {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
         {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
         {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
         {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
         {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
         {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
         {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
         {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
         {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
         {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
         {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
         {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
         {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
         {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
         {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
         {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
         {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
         {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
         {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
         {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
         {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
         {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
         {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
         {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
         {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
         {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
         {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
         {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
         {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
         {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
         {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
         {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
         {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};
// the probability that each coefficient probability is updated
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
         {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
         {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
         {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};
// the key-frame 4x4 mode probabilities [above][left][node]
const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103}, {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173}, {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26}, {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226}, {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128}, {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157}, {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7}, {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194}, {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171}, {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64}, {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31}, {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124}, {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114}, {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154}, {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71}, {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221}, {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154}, {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183}, {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37}, {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223}, {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226}, {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213}, {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255}, {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51}, {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192}, {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1}, {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85}, {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6}, {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43}, {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171}, {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1}, {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16}, {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128}, {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128}, {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197}, {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28}, {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246}, {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45}, {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138}, {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20}, {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163}, {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbering; 16x16 and chroma modes share the first four
// (DC_NOTOP, DC_NOLEFT and DC_NOTOPLEFT are DC at the frame's edges)
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT,
  DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED
};

// libwebp's VP8BitReader: range holds range - 1, value the unread bits,
// bits the number of them beyond the 8 in use
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  int eof = 0;

  void init(const uint8_t* start, size_t size) {
    range = 254;
    value = 0;
    bits = -8;
    eof = 0;
    buf = start;
    end = start + size;
    load();
  }
  void load() {
    if (end - buf >= 8) {  // 56 bits at once
      uint64_t v = 0;
      for (int i = 0; i < 7; ++i) v = (v << 8) | buf[i];
      buf += 7;
      value = v | (value << 56);
      bits += 56;
    } else if (buf < end) {  // one byte at a time at the end
      bits += 8;
      value = *buf++ | (value << 8);
    } else if (!eof) {  // past the end: one zero byte, flagged
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(get(0x80)) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = static_cast<int>(value_bits(n));
    return get(0x80) ? -v : v;
  }
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  uint8_t limit, ilevel, inner, hev;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct Context {
  uint8_t nz, nz_dc;
};

// the reconstruction buffer of one macroblock (frame_dec.c's yuv_b_):
// a 16x16 luma and two 8x8 chroma blocks with their top row and left column
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
                           8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                           0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return (v & ~0xff) == 0 ? static_cast<uint8_t>(v) : v < 0 ? 0 : 255; }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// dec.c's TransformOne: the inverse DCT, added to the prediction
void transform(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

// dec.c's TransformWHT: the second-order transform of a 16x16 macroblock's
// DCs into each 4x4 block's coefficient 0
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction (dec.c), into the BPS-strided buffer -------------

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// 16x16 luma (size 16, log 5) or 8x8 chroma (size 8, log 4)
void predict_block(uint8_t* dst, int mode, int size, int log) {
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> log);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> (log - 1));
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, size, dc >> (log - 1));
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    default:
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
    default:
      break;
  }
}

#undef DST

// frame_dec.c's CheckMode: DC at the frame's top and left edges
inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

// ---- loop filter (dec.c) ----------------------------------------------

inline int clampi(int v, int lo, int hi) { return std::min(std::max(v, lo), hi); }
inline int sclip1(int v) { return clampi(v, -128, 127); }  // VP8ksclip1
inline int sclip2(int v) { return clampi(v, -16, 15); }    // VP8ksclip2
inline int iabs(int v) { return std::abs(v); }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return iabs(p1 - p0) > thresh || iabs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * iabs(p0 - q0) + iabs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
  return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it && iabs(q3 - q2) <= it &&
         iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}

// SimpleVFilter16 / SimpleHFilter16: 16 positions vstride apart, each
// across the edge hstride apart
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

// FilterLoop26 (a macroblock edge) and FilterLoop24 (an inner edge)
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh,
                 bool macroblock_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (; size > 0; --size, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      do_filter2(p, hstride);
    else if (macroblock_edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

// ---- output: fancy upsampling (upsampling.c) and yuv.h -----------------

inline uint8_t yuv_clip(int v) { return static_cast<uint8_t>(clampi(v, 0, 16383) >> 6); }

// VP8YuvToRgb on one row of luma and its upsampled chroma, C bytes a pixel
// (3: RGB, 4: RGBA, its alpha left as it is)
template <int C>
void yuv_row(const uint8_t* y, const uint8_t* u, const uint8_t* v, uint8_t* dst, int len) {
  for (int x = 0; x < len; ++x) {
    const int yy = (y[x] * 19077) >> 8, uu = u[x], vv = v[x];
    dst[x * C] = yuv_clip(yy + ((vv * 26149) >> 8) - 14234);
    dst[x * C + 1] = yuv_clip(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708);
    dst[x * C + 2] = yuv_clip(yy + ((uu * 33050) >> 8) - 17685);
  }
}

// One chroma channel of a luma row, from the chroma row nearest it (near)
// and the next nearest (far; the same row at the frame's top and at the
// bottom of an even height): UpsampleRgbaLinePair's 9-3-3-1 arithmetic
// and rounding, which treats its top and bottom rows alike with the roles
// of the two chroma rows swapped
void upsample_row(const uint8_t* near, const uint8_t* far, uint8_t* out, int len) {
  const int last_pair = (len - 1) >> 1;
  out[0] = static_cast<uint8_t>((3 * near[0] + far[0] + 2) >> 2);
  for (int x = 1; x <= last_pair; ++x) {
    const int a0 = near[x - 1], a1 = near[x], b0 = far[x - 1], b1 = far[x];
    const int avg = a0 + a1 + b0 + b1 + 8;
    const int diag_near = (avg + 2 * (a1 + b0)) >> 3;
    const int diag_far = (avg + 2 * (a0 + b1)) >> 3;
    out[2 * x - 1] = static_cast<uint8_t>((diag_near + a0) >> 1);
    out[2 * x] = static_cast<uint8_t>((diag_far + a1) >> 1);
  }
  if (!(len & 1)) out[len - 1] = static_cast<uint8_t>((3 * near[last_pair] + far[last_pair] + 2) >> 2);
}

struct Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int seg_quantizer[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  int parse_header(const uint8_t* data, size_t size, size_t chunk_size);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  void parse_intra_mode(MBData& block, uint8_t* top, uint8_t* left);
  int get_coeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n, int16_t* out);
  bool parse_residuals(MBData& block, Context& mb, Context& left, BoolReader& tbr);
};

int Decoder::parse_header(const uint8_t* data, size_t size, size_t chunk_size) {
  // the frame tag and key-frame header (VP8GetInfo, VP8GetHeaders)
  if (size < 10) return kTruncated;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kBadHeader;
  if (!key_frame || profile > 3 || !show || partition_length >= chunk_size) return kBadHeader;
  width = ((data[7] << 8) | data[6]) & 0x3fff;  // the scale bits are ignored
  height = ((data[9] << 8) | data[8]) & 0x3fff;
  if (width == 0 || height == 0) return kBadHeader;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  if (partition_length > buf_size) return kTruncated;
  br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type: libwebp always clamps
  // segments
  use_segment = br.value_bits(1);
  if (use_segment) {
    update_map = br.value_bits(1);
    if (br.value_bits(1)) {
      absolute_delta = br.value_bits(1);
      for (int s = 0; s < 4; ++s) seg_quantizer[s] = br.value_bits(1) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) seg_filter[s] = br.value_bits(1) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.value_bits(1) ? static_cast<uint8_t>(br.value_bits(8)) : 255;
  } else {
    update_map = 0;
  }
  if (br.eof) return kPartition0End;
  // the loop filter
  simple = br.value_bits(1);
  level = br.value_bits(6);
  sharpness = br.value_bits(3);
  use_lf_delta = br.value_bits(1);
  if (use_lf_delta && br.value_bits(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) mode_lf_delta[i] = br.signed_value(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return kPartition0End;
  // the token partitions: sizes of all but the last, which takes the rest
  num_parts_minus_one = (1 << br.value_bits(2)) - 1;
  const size_t last_part = num_parts_minus_one;
  if (buf_size < 3 * last_part) return kTruncated;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  const uint8_t* const buf_end = buf + buf_size;
  size_t size_left = buf_size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last_part].init(part_start, size_left);
  if (part_start >= buf_end) return kTruncated;
  parse_quant();
  br.value_bits(1);  // update_proba, meaningless for a key frame
  parse_proba();
  return 0;
}

inline int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void Decoder::parse_quant() {
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = seg_quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      q = base_q0;
    }
    Quant& m = dqm[i];
    m.y1[0] = kDcTable[clip_q(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip_q(q, 127)];
    m.y2[0] = kDcTable[clip_q(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip_q(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip_q(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip_q(q + dquv_ac, 127)];
  }
}

void Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p]) ? static_cast<uint8_t>(br.value_bits(8))
                                                                       : kCoeffsProba0[t][b][c][p];
  use_skip_proba = br.value_bits(1);
  if (use_skip_proba) skip_p = br.value_bits(8);
}

void Decoder::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = seg_filter[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = static_cast<uint8_t>(ilevel);
        info.limit = static_cast<uint8_t>(2 * lvl + ilevel);
        info.hev = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
        info.ilevel = 0;
        info.hev = 0;
      }
      info.inner = static_cast<uint8_t>(i4x4);
    }
  }
}

// tree_dec.c's ParseIntraMode; top holds the 4x4 modes above (4 a
// macroblock), left those to the left
void Decoder::parse_intra_mode(MBData& block, uint8_t* top, uint8_t* left) {
  if (update_map) {
    block.segment = !br.get(seg_proba[0]) ? static_cast<uint8_t>(br.get(seg_proba[1]))
                                          : static_cast<uint8_t>(br.get(seg_proba[2]) + 2);
  } else {
    block.segment = 0;
  }
  if (use_skip_proba) block.skip = static_cast<uint8_t>(br.get(skip_p));
  block.is_i4x4 = !br.get(145);
  if (!block.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
    block.imodes[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba[top[x]][ymode];
        ymode = !br.get(prob[0])   ? B_DC_PRED
                : !br.get(prob[1]) ? B_TM_PRED
                : !br.get(prob[2]) ? B_VE_PRED
                : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE_PRED : (!br.get(prob[5]) ? B_RD_PRED : B_VR_PRED))
                                   : (!br.get(prob[6]) ? B_LD_PRED
                                      : !br.get(prob[7]) ? B_VL_PRED
                                      : !br.get(prob[8]) ? B_HD_PRED
                                                         : B_HU_PRED);
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  block.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
}

int large_value(BoolReader& tbr, const uint8_t* p) {
  int v;
  if (!tbr.get(p[3])) {
    v = !tbr.get(p[4]) ? 2 : 3 + tbr.get(p[5]);
  } else if (!tbr.get(p[6])) {
    if (!tbr.get(p[7])) {
      v = 5 + tbr.get(159);
    } else {
      v = 7 + 2 * tbr.get(165);
      v += tbr.get(145);
    }
  } else {
    const int bit1 = tbr.get(p[8]);
    const int bit0 = tbr.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tbr.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// vp8_dec.c's GetCoeffs: the tokens of one 4x4 block from coefficient n,
// dequantised into out (raster order); returns the position after the last
// token read (16 when the block runs to its end)
int Decoder::get_coeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tbr.get(p[0])) return n;  // end of block
    while (!tbr.get(p[1])) {       // a zero
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!tbr.get(p[2])) {
      v = 1;
      p = proba[type][kBands[n + 1]][1];
    } else {
      v = large_value(tbr, p);
      p = proba[type][kBands[n + 1]][2];
    }
    out[kZigzag[n]] = static_cast<int16_t>((tbr.get(0x80) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// vp8_dec.c's ParseResiduals; true when every coefficient is zero
bool Decoder::parse_residuals(MBData& block, Context& mb, Context& left_mb, BoolReader& tbr) {
  const Quant& q = dqm[block.segment];
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, 384 * sizeof(*dst));
  int first, ac_type;
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left_mb.nz_dc;
    const int nz = get_coeffs(tbr, 1, ctx, q.y2, 0, dc);
    mb.nz_dc = left_mb.nz_dc = static_cast<uint8_t>(nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = mb.nz & 0x0f, lnz = left_mb.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(tbr, ac_type, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = static_cast<uint8_t>(mb.nz >> (4 + ch));
    lnz = static_cast<uint8_t>(left_mb.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, 2, ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (static_cast<uint32_t>(tnz) << 4) << ch;
    out_l_nz |= (lnz & 0xf0u) << ch;
  }
  mb.nz = static_cast<uint8_t>(out_t_nz);
  left_mb.nz = static_cast<uint8_t>(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// frame_dec.c's ReconstructRow for one macroblock row, into the frame's
// unfiltered planes
void reconstruct_row(const Decoder& dec, const std::vector<MBData>& blocks, int mb_y, std::vector<TopSamples>& top,
                     uint8_t* yuv_b, uint8_t* ys, uint8_t* us, uint8_t* vs, size_t y_stride, size_t uv_stride) {
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = 129;
    v_dst[j * BPS - 1] = 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < dec.mb_w; ++mb_x) {
    const MBData& block = blocks[mb_x];
    if (mb_x > 0) {  // the left samples from the previous macroblock
      for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    TopSamples* const top_yuv = top.data() + mb_x;
    const int16_t* const coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
      std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
      std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
    }
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= dec.mb_w - 1)
          std::memset(top_right, top_yuv[0].y[15], 4);
        else
          std::memcpy(top_right, top_yuv[1].y, 4);
      }
      // the top-right pixels replicated beside sub-block rows 1-3
      for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        predict4(dst, block.imodes[n]);
        if (bits >> 30) transform(coeffs + n * 16, dst);
      }
    } else {
      predict_block(y_dst, check_mode(mb_x, mb_y, block.imodes[0]), 16, 5);
      if (bits != 0)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          if (bits >> 30) transform(coeffs + n * 16, y_dst + kScan[n]);
    }
    const uint32_t bits_uv = block.non_zero_uv;
    const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
    predict_block(u_dst, uv_mode, 8, 4);
    predict_block(v_dst, uv_mode, 8, 4);
    for (int c = 0; c < 2; ++c) {
      uint8_t* const dst = c ? v_dst : u_dst;
      if ((bits_uv >> (8 * c)) & 0xff) {
        const int16_t* src = coeffs + (16 + 4 * c) * 16;
        transform(src, dst);
        transform(src + 16, dst + 4);
        transform(src + 32, dst + 4 * BPS);
        transform(src + 48, dst + 4 * BPS + 4);
      }
    }
    if (mb_y < dec.mb_h - 1) {
      std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
      std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
      std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j)
      std::memcpy(ys + (static_cast<size_t>(mb_y) * 16 + j) * y_stride + mb_x * 16, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(us + (static_cast<size_t>(mb_y) * 8 + j) * uv_stride + mb_x * 8, u_dst + j * BPS, 8);
      std::memcpy(vs + (static_cast<size_t>(mb_y) * 8 + j) * uv_stride + mb_x * 8, v_dst + j * BPS, 8);
    }
  }
}

// frame_dec.c's DoFilter on one macroblock of the frame
void filter_mb(int filter_type, const FInfo& f, int mb_x, int mb_y, uint8_t* ys, uint8_t* us, uint8_t* vs,
               int y_stride, int uv_stride) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* const y_dst = ys + static_cast<size_t>(mb_y) * 16 * y_stride + mb_x * 16;
  if (filter_type == 1) {
    if (mb_x > 0) simple_filter(y_dst, 1, y_stride, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, y_stride, limit);
    if (mb_y > 0) simple_filter(y_dst, y_stride, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * y_stride, y_stride, 1, limit);
    return;
  }
  uint8_t* const u_dst = us + static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8;
  uint8_t* const v_dst = vs + static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8;
  const int ilevel = f.ilevel, hev_t = f.hev;
  if (mb_x > 0) {
    filter_loop(y_dst, 1, y_stride, 16, limit + 4, ilevel, hev_t, true);
    filter_loop(u_dst, 1, uv_stride, 8, limit + 4, ilevel, hev_t, true);
    filter_loop(v_dst, 1, uv_stride, 8, limit + 4, ilevel, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k, 1, y_stride, 16, limit, ilevel, hev_t, false);
    filter_loop(u_dst + 4, 1, uv_stride, 8, limit, ilevel, hev_t, false);
    filter_loop(v_dst + 4, 1, uv_stride, 8, limit, ilevel, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(y_dst, y_stride, 1, 16, limit + 4, ilevel, hev_t, true);
    filter_loop(u_dst, uv_stride, 1, 8, limit + 4, ilevel, hev_t, true);
    filter_loop(v_dst, uv_stride, 1, 8, limit + 4, ilevel, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k)
      filter_loop(y_dst + 4 * k * y_stride, y_stride, 1, 16, limit, ilevel, hev_t, false);
    filter_loop(u_dst + 4 * uv_stride, uv_stride, 1, 8, limit, ilevel, hev_t, false);
    filter_loop(v_dst + 4 * uv_stride, uv_stride, 1, 8, limit, ilevel, hev_t, false);
  }
}

int decode(const uint8_t* data, size_t size, size_t chunk_size, const uint8_t* alpha, size_t alpha_size,
           uint8_t* out, int channels, int out_h, int out_w) {
  Decoder dec;
  int rc = dec.parse_header(data, size, chunk_size);
  if (rc != 0) return rc;
  dec.precompute_filter_strengths();
  const int mb_w = dec.mb_w, mb_h = dec.mb_h;
  const int y_stride = mb_w * 16, uv_stride = mb_w * 8;
  std::vector<uint8_t> yp(static_cast<size_t>(y_stride) * mb_h * 16), up(static_cast<size_t>(uv_stride) * mb_h * 8),
      vp(static_cast<size_t>(uv_stride) * mb_h * 8);
  std::vector<uint8_t> intra_t(4 * static_cast<size_t>(mb_w), B_DC_PRED);
  uint8_t intra_l[4];
  std::vector<Context> contexts(mb_w + 1, Context{0, 0});  // [0] is the left neighbour
  std::vector<TopSamples> top(mb_w);
  std::vector<FInfo> finfo(static_cast<size_t>(mb_w) * mb_h, FInfo{0, 0, 0, 0});
  std::vector<MBData> blocks(mb_w);
  std::vector<uint8_t> yuv_b(YUV_SIZE, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    std::memset(intra_l, B_DC_PRED, 4);
    contexts[0] = Context{0, 0};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      blocks[mb_x].skip = 0;
      dec.parse_intra_mode(blocks[mb_x], &intra_t[4 * mb_x], intra_l);
    }
    if (dec.br.eof) return kPartition0End;
    BoolReader& tbr = dec.parts[mb_y & dec.num_parts_minus_one];
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& block = blocks[mb_x];
      Context& mb = contexts[mb_x + 1];
      Context& left = contexts[0];
      int skip = dec.use_skip_proba ? block.skip : 0;
      if (!skip) {
        skip = dec.parse_residuals(block, mb, left, tbr);
      } else {
        left.nz = mb.nz = 0;
        if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (dec.filter_type > 0) {
        FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
        f = dec.fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
      }
      if (tbr.eof) return kTokenEnd;
    }
    reconstruct_row(dec, blocks, mb_y, top, yuv_b.data(), yp.data(), up.data(), vp.data(), y_stride, uv_stride);
  }
  if (dec.filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        filter_mb(dec.filter_type, finfo[static_cast<size_t>(mb_y) * mb_w + mb_x], mb_x, mb_y, yp.data(), up.data(),
                  vp.data(), y_stride, uv_stride);
  const int W = dec.width, H = dec.height;
  if (W != out_w || H != out_h) return kBadHeader;
  const size_t npix = static_cast<size_t>(W) * H;
  std::vector<uint8_t> plane;
  if (alpha != nullptr) {  // decoded and checked even where RGB drops it
    plane.resize(npix);
    rc = sfod_webp::alpha_plane(alpha, alpha_size, W, H, plane.data());
    if (rc != 0) return rc == -9 ? -11 : rc == -10 ? -12 : rc;
  }
  if (channels == 4)
    for (size_t i = 0; i < npix; ++i) out[4 * i + 3] = alpha != nullptr ? plane[i] : 255;
  // EmitFancyRGB over the whole frame: row 0 from chroma row 0 alone, row
  // 2k - 1 nearest chroma row k - 1 and row 2k nearest row k, the last row
  // of an even height from its chroma row alone
  const int uv_h = (H + 1) / 2;
  std::vector<uint8_t> u_row(W), v_row(W);
  for (int r = 0; r < H; ++r) {
    const int near = r >> 1;
    const int far = r == 0 ? 0 : !(r & 1) ? near - 1 : near + 1 < uv_h ? near + 1 : near;
    upsample_row(up.data() + static_cast<size_t>(near) * uv_stride, up.data() + static_cast<size_t>(far) * uv_stride,
                 u_row.data(), W);
    upsample_row(vp.data() + static_cast<size_t>(near) * uv_stride, vp.data() + static_cast<size_t>(far) * uv_stride,
                 v_row.data(), W);
    const uint8_t* y = yp.data() + static_cast<size_t>(r) * y_stride;
    uint8_t* dst = out + static_cast<size_t>(r) * W * channels;
    if (channels == 4)
      yuv_row<4>(y, u_row.data(), v_row.data(), dst, W);
    else
      yuv_row<3>(y, u_row.data(), v_row.data(), dst, W);
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode a VP8 chunk's payload (n bytes, its pad byte included, as
// libwebp's demuxer hands it over; chunk_size is the size its chunk header
// gives) and, when alpha is not null, the frame's ALPH payload into out
// [h, w, channels]: RGB (3; the alpha plane decoded and checked, then
// dropped) or RGBA (4; alpha 255 without ALPH). h and w are the frame's
// size as its header gives it. 0, or a negative code.
int32_t sfod_webp_vp8_decode(const uint8_t* data, int64_t n, int64_t chunk_size, const uint8_t* alpha,
                             int64_t alpha_size, uint8_t* out, int32_t channels, int32_t h, int32_t w) {
  try {
    return decode(data, static_cast<size_t>(n), static_cast<size_t>(chunk_size), alpha,
                  static_cast<size_t>(alpha_size), out, channels, h, w);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"

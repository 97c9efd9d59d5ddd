// CCITT bilevel decoding for TIFF compressions 2 (Modified Huffman RLE),
// 32771 (its word-aligned form), 3 (Group 3, one- and two-dimensional) and
// 4 (Group 4), after libtiff 4.7's tif_fax3.c, tif_fax3.h and mkg3states.c,
// so that a strip decodes to libtiff's bits, damaged lines included:
//
//   tables   mkg3states.c's state tables, built here at first use from the
//            T.4 code lists: the 2-D mode table (7 bits), the white (12) and
//            black (13) run tables indexed LSB first, the extended make-up
//            codes in both, 11 zero bits an EOL
//   bits     tif_fax3.h's NeedBits8/NeedBits16 (zeros padded once the data
//            ends, EOF only with no bit left), GetBits/ClrBits over an LSB
//            first accumulator fed through the bit-reversal table unless
//            FillOrder is 2
//   lines    EXPAND1D and EXPAND2D with CHECK_b1, SETVALUE and CLEANUP_RUNS;
//            SYNC_EOL before each Group 3 line; an unknown code word, a bad
//            VL, an uncompressed-mode extension or a bad EOL ends the line
//            where libtiff only reports it, and the run array is patched as
//            libtiff patches it; where the data ends early libtiff fills
//            that row and stops, leaving the rest of Pillow's strip buffer
//            as it was: an end inside the last row's runs is decoded, any
//            other is refused (its rows would be old memory)
//   fill     _TIFFFax3fillruns: white runs clear bits, black runs set them,
//            MSB first
//   RLE      Fax3DecodeRLE: no EOLs, each row byte-aligned (2) or word-aligned
//            (32771), the latter by the data's address, which libtiff reads in
//            place from the file: the parity of the strip's file offset

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum State : uint8_t { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
                       S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state = S_Null;
  uint8_t width = 0;
  uint32_t param = 0;
};

// a code as the T.4 recommendation prints it (MSB first) and its run
struct Code {
  const char* bits;
  int run;
};

const Code kWhiteTerm[] = {
    {"00110101", 0},   {"000111", 1},     {"0111", 2},       {"1000", 3},       {"1011", 4},       {"1100", 5},
    {"1110", 6},       {"1111", 7},       {"10011", 8},      {"10100", 9},      {"00111", 10},     {"01000", 11},
    {"001000", 12},    {"000011", 13},    {"110100", 14},    {"110101", 15},    {"101010", 16},    {"101011", 17},
    {"0100111", 18},   {"0001100", 19},   {"0001000", 20},   {"0010111", 21},   {"0000011", 22},   {"0000100", 23},
    {"0101000", 24},   {"0101011", 25},   {"0010011", 26},   {"0100100", 27},   {"0011000", 28},   {"00000010", 29},
    {"00000011", 30},  {"00011010", 31},  {"00011011", 32},  {"00010010", 33},  {"00010011", 34},  {"00010100", 35},
    {"00010101", 36},  {"00010110", 37},  {"00010111", 38},  {"00101000", 39},  {"00101001", 40},  {"00101010", 41},
    {"00101011", 42},  {"00101100", 43},  {"00101101", 44},  {"00000100", 45},  {"00000101", 46},  {"00001010", 47},
    {"00001011", 48},  {"01010010", 49},  {"01010011", 50},  {"01010100", 51},  {"01010101", 52},  {"00100100", 53},
    {"00100101", 54},  {"01011000", 55},  {"01011001", 56},  {"01011010", 57},  {"01011011", 58},  {"01001010", 59},
    {"01001011", 60},  {"00110010", 61},  {"00110011", 62},  {"00110100", 63},
};
const Code kWhiteMakeUp[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},     {"0110111", 256},    {"00110110", 320},
    {"00110111", 384},   {"01100100", 448},   {"01100101", 512},   {"01101000", 576},   {"01100111", 640},
    {"011001100", 704},  {"011001101", 768},  {"011010010", 832},  {"011010011", 896},  {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664},    {"010011011", 1728},
};
const Code kBlackTerm[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},           {"10", 3},           {"011", 4},
    {"0011", 5},         {"0010", 6},         {"00011", 7},        {"000101", 8},       {"000100", 9},
    {"0000100", 10},     {"0000101", 11},     {"0000111", 12},     {"00000100", 13},    {"00000111", 14},
    {"000011000", 15},   {"0000010111", 16},  {"0000011000", 17},  {"0000001000", 18},  {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23}, {"00000010111", 24},
    {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54},
    {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63},
};
const Code kBlackMakeUp[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},  {"000001011011", 256},
    {"000000110011", 320},  {"000000110100", 384},  {"000000110101", 448},  {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728},
};
// the extended make-up codes, white and black alike
const Code kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},  {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560},
};
// the 2-D mode codes: pass, horizontal, V0, VR1-3, VL1-3, the extension, and
// seven zero bits (an EOL) in the 7-bit main table
const Code kMain[] = {
    {"0001", S_Pass}, {"001", S_Horiz}, {"1", S_V0}, {"011", S_VR + 16}, {"000011", S_VR + 32},
    {"0000011", S_VR + 48}, {"010", S_VL + 16}, {"000010", S_VL + 32}, {"0000010", S_VL + 48},
    {"0000001", S_Ext}, {"0000000", S_EOL},
};

// mkg3states.c:FillTable: every index whose low bits are the code read LSB
// first
void fill(TabEnt* t, int size, const Code* codes, size_t n, int state) {
  for (size_t i = 0; i < n; i++) {
    const int width = static_cast<int>(strlen(codes[i].bits));
    int code = 0;
    for (int b = 0; b < width; b++) code |= (codes[i].bits[b] - '0') << b;
    int st = state, param = codes[i].run;
    if (state < 0) {  // the main table: the state, and the VR/VL offset above it
      st = codes[i].run & 15;
      param = codes[i].run >> 4;
    }
    for (int k = code; k < (1 << size); k += 1 << width) {
      t[k].state = static_cast<uint8_t>(st);
      t[k].width = static_cast<uint8_t>(width);
      t[k].param = static_cast<uint32_t>(param);
    }
  }
}

struct Tables {
  TabEnt main[128], white[4096], black[8192];
  uint8_t bitrev[256];
  Tables() {
    const Code eol[] = {{"00000000000", 0}};
    fill(main, 7, kMain, sizeof(kMain) / sizeof(Code), -1);
    fill(white, 12, kWhiteMakeUp, sizeof(kWhiteMakeUp) / sizeof(Code), S_MakeUpW);
    fill(white, 12, kMakeUp, sizeof(kMakeUp) / sizeof(Code), S_MakeUp);
    fill(white, 12, kWhiteTerm, sizeof(kWhiteTerm) / sizeof(Code), S_TermW);
    fill(white, 12, eol, 1, S_EOL);
    fill(black, 13, kBlackMakeUp, sizeof(kBlackMakeUp) / sizeof(Code), S_MakeUpB);
    fill(black, 13, kMakeUp, sizeof(kMakeUp) / sizeof(Code), S_MakeUp);
    fill(black, 13, kBlackTerm, sizeof(kBlackTerm) / sizeof(Code), S_TermB);
    fill(black, 13, eol, 1, S_EOL);
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
      bitrev[i] = static_cast<uint8_t>(r);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

enum Kind { kRLE = 0, kRLEW = 1, kG3_1D = 2, kG3_2D = 3, kG4 = 4 };

struct Eof {};       // the data ran out where libtiff jumps to its EOF label
struct Overflow {};  // libtiff's "Buffer overflow" refusal

// _TIFFFax3fillruns
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; colour++) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (run) {
        for (uint32_t k = x; k < x + run; k++) {
          if (colour)
            buf[k >> 3] |= static_cast<uint8_t>(0x80 >> (k & 7));
          else
            buf[k >> 3] &= static_cast<uint8_t>(~(0x80 >> (k & 7)));
        }
        x += runs[colour];
      }
    }
  }
}

struct Fax {
  const Tables& T = tables();
  const uint8_t* cp;
  const uint8_t* ep;
  bool reverse;
  int64_t base_parity;  // the parity of the file offset of the data's first byte
  const uint8_t* start;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  int32_t lastx;
  uint32_t nruns;
  std::vector<uint32_t> runs;
  uint32_t* curruns;
  uint32_t* refruns;
  // the line's state (tif_fax3.h's locals)
  int32_t a0 = 0, RunLength = 0, b1 = 0;
  uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
  const TabEnt* TabEnt_ = nullptr;

  uint8_t next_byte() {
    const uint8_t b = *cp++;
    return reverse ? T.bitrev[b] : b;
  }
  bool end_of_data() const { return cp >= ep; }
  void need_bits8(int n) {
    if (BitsAvail < n) {
      if (end_of_data()) {
        if (BitsAvail == 0) throw Eof{};
        BitsAvail = n;
      } else {
        BitAcc |= static_cast<uint32_t>(next_byte()) << BitsAvail;
        BitsAvail += 8;
      }
    }
  }
  void need_bits16(int n) {
    if (BitsAvail < n) {
      if (end_of_data()) {
        if (BitsAvail == 0) throw Eof{};
        BitsAvail = n;
      } else {
        BitAcc |= static_cast<uint32_t>(next_byte()) << BitsAvail;
        if ((BitsAvail += 8) < n) {
          if (end_of_data()) {
            BitsAvail = n;
          } else {
            BitAcc |= static_cast<uint32_t>(next_byte()) << BitsAvail;
            BitsAvail += 8;
          }
        }
      }
    }
  }
  uint32_t get_bits(int n) const { return BitAcc & ((1u << n) - 1); }
  void clr_bits(int n) {
    BitsAvail -= n;
    BitAcc >>= n;
  }
  const TabEnt& lookup8(int wid, const TabEnt* tab) {
    need_bits8(wid);
    const TabEnt& e = tab[get_bits(wid)];
    clr_bits(e.width);
    return e;
  }
  const TabEnt& lookup16(int wid, const TabEnt* tab) {
    need_bits16(wid);
    const TabEnt& e = tab[get_bits(wid)];
    clr_bits(e.width);
    return e;
  }

  void setvalue(uint32_t x) {
    if (pa >= thisrun + nruns) throw Overflow{};
    *pa++ = static_cast<uint32_t>(RunLength) + x;
    a0 += static_cast<int32_t>(x);
    RunLength = 0;
  }

  void cleanup_runs() {
    if (RunLength) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= static_cast<int32_t>(*--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(static_cast<uint32_t>(lastx - a0));
      } else if (a0 > lastx) {
        setvalue(static_cast<uint32_t>(lastx));
        setvalue(0);
      }
    }
  }

  // SYNC_EOL
  void sync_eol() {
    if (EOLcnt == 0) {
      for (;;) {
        need_bits16(11);
        if (get_bits(11) == 0) break;
        clr_bits(1);
      }
    }
    for (;;) {
      need_bits8(8);
      if (get_bits(8)) break;
      clr_bits(8);
    }
    while (get_bits(1) == 0) clr_bits(1);
    clr_bits(1);
    EOLcnt = 0;
  }

  // EXPAND1D; an Eof propagates after CLEANUP_RUNS (libtiff's eof1d)
  void expand1d() {
    try {
      for (;;) {
        bool done = false;
        for (;;) {
          const TabEnt& e = lookup16(12, T.white);
          if (e.state == S_EOL) {
            EOLcnt = 1;
            done = true;
            break;
          }
          if (e.state == S_TermW) {
            setvalue(e.param);
            break;
          }
          if (e.state == S_MakeUpW || e.state == S_MakeUp) {
            a0 += static_cast<int32_t>(e.param);
            RunLength += static_cast<int32_t>(e.param);
            continue;
          }
          done = true;  // unexpected("WhiteTable")
          break;
        }
        if (done || a0 >= lastx) break;
        for (;;) {
          const TabEnt& e = lookup16(13, T.black);
          if (e.state == S_EOL) {
            EOLcnt = 1;
            done = true;
            break;
          }
          if (e.state == S_TermB) {
            setvalue(e.param);
            break;
          }
          if (e.state == S_MakeUpB || e.state == S_MakeUp) {
            a0 += static_cast<int32_t>(e.param);
            RunLength += static_cast<int32_t>(e.param);
            continue;
          }
          done = true;  // unexpected("BlackTable")
          break;
        }
        if (done || a0 >= lastx) break;
        if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
    cleanup_runs();
  }

  // CHECK_b1
  void check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) throw Overflow{};
        b1 += static_cast<int32_t>(pb[0] + pb[1]);
        pb += 2;
      }
  }

  // a run of the colour `black` in horizontal mode: false on a bad code
  bool horiz_run(bool black) {
    for (;;) {
      const TabEnt& e = black ? lookup16(13, T.black) : lookup16(12, T.white);
      if (e.state == (black ? S_TermB : S_TermW)) {
        setvalue(e.param);
        return true;
      }
      if (e.state == (black ? S_MakeUpB : S_MakeUpW) || e.state == S_MakeUp) {
        a0 += static_cast<int32_t>(e.param);
        RunLength += static_cast<int32_t>(e.param);
        continue;
      }
      return false;
    }
  }

  // EXPAND2D
  void expand2d() {
    try {
      bool eol = false;
      while (a0 < lastx) {
        if (pa >= thisrun + nruns) throw Overflow{};
        const TabEnt& e = lookup8(7, T.main);
        switch (e.state) {
          case S_Pass:
            check_b1();
            if (pb + 1 >= refruns + nruns) throw Overflow{};
            b1 += static_cast<int32_t>(*pb++);
            RunLength += b1 - a0;
            a0 = b1;
            b1 += static_cast<int32_t>(*pb++);
            break;
          case S_Horiz: {
            const bool black_first = (pa - thisrun) & 1;
            if (!horiz_run(black_first) || !horiz_run(!black_first)) {
              eol = true;  // unexpected("BlackTable"/"WhiteTable")
              break;
            }
            check_b1();
            break;
          }
          case S_V0:
            check_b1();
            setvalue(static_cast<uint32_t>(b1 - a0));
            if (pb >= refruns + nruns) throw Overflow{};
            b1 += static_cast<int32_t>(*pb++);
            break;
          case S_VR:
            check_b1();
            setvalue(static_cast<uint32_t>(b1 - a0 + static_cast<int32_t>(e.param)));
            if (pb >= refruns + nruns) throw Overflow{};
            b1 += static_cast<int32_t>(*pb++);
            break;
          case S_VL:
            check_b1();
            if (b1 < a0 + static_cast<int32_t>(e.param)) {
              eol = true;  // unexpected("VL")
              break;
            }
            setvalue(static_cast<uint32_t>(b1 - a0 - static_cast<int32_t>(e.param)));
            b1 -= static_cast<int32_t>(*--pb);
            break;
          case S_Ext:
            *pa++ = static_cast<uint32_t>(lastx - a0);  // extension(): uncompressed mode is not decoded
            eol = true;
            break;
          case S_EOL:
            *pa++ = static_cast<uint32_t>(lastx - a0);
            need_bits8(4);
            clr_bits(4);  // unexpected("EOL") when the 4 bits are not zero
            EOLcnt = 1;
            eol = true;
            break;
          default:
            eol = true;  // unexpected("MainTable")
            break;
        }
        if (eol) break;
      }
      if (!eol && RunLength) {
        if (RunLength + a0 < lastx) {  // expect a final V0
          need_bits8(1);
          if (!get_bits(1)) {
            cleanup_runs();  // badMain2d
            return;
          }
          clr_bits(1);
        }
        setvalue(0);
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
    cleanup_runs();
  }
};

}  // namespace

extern "C" {

// Decode one strip or tile of CCITT data (n bytes) into `rows` rows of
// `width` bilevel pixels, row_bytes apart, MSB first, 1 = black run. kind:
// 0 Modified Huffman RLE, 1 its word-aligned form, 2 Group 3 1-D, 3 Group 3
// 2-D (T4Options bit 0), 4 Group 4. lsb_first: FillOrder 2. odd_start: the
// data's first byte lies at an odd file offset (for the word alignment).
// Returns 0, or -1 when the data ends early (libtiff fails the strip), -2
// on libtiff's run-buffer overflow, -3 when Group 4 data ends after its
// first row.
int32_t sfod_ccitt_decode(const uint8_t* data, int64_t n, int32_t kind, int32_t lsb_first, int32_t odd_start,
                          int32_t width, int32_t rows, uint8_t* out, int64_t row_bytes) {
  Fax f;
  f.cp = data;
  f.ep = data + n;
  f.start = data;
  // tif_fax3.c:Fax3PreDecode: the table reverses bytes unless FillOrder is 2
  f.reverse = !lsb_first;
  f.base_parity = odd_start & 1;
  f.lastx = width;
  const bool ref = kind == kG3_2D || kind == kG4;
  uint32_t nruns = (static_cast<uint32_t>(width) + 1 + 31) / 32 * 32;
  if (ref) nruns *= 2;
  f.nruns = nruns;
  f.runs.assign(static_cast<size_t>(nruns) * 2, 0);
  f.curruns = f.runs.data();
  f.refruns = ref ? f.runs.data() + nruns : nullptr;
  if (ref) {
    f.refruns[0] = static_cast<uint32_t>(width);
    f.refruns[1] = 0;
  }
  int line = 0;
  bool expanding = false;  // an Eof inside EXPAND1D/EXPAND2D (not SYNC_EOL)
  try {
    for (; line < rows; line++) {
      uint8_t* buf = out + static_cast<int64_t>(line) * row_bytes;
      f.a0 = 0;
      f.RunLength = 0;
      f.pa = f.thisrun = f.curruns;
      try {
        expanding = kind == kRLE || kind == kRLEW || kind == kG4;
        if (kind == kRLE || kind == kRLEW) {
          f.expand1d();
        } else if (kind == kG3_1D) {
          f.sync_eol();
          expanding = true;
          f.expand1d();
        } else if (kind == kG3_2D) {
          f.sync_eol();
          f.need_bits8(1);
          expanding = true;
          const bool is1d = f.get_bits(1);
          f.clr_bits(1);
          f.pb = f.refruns;
          f.b1 = static_cast<int32_t>(*f.pb++);
          if (is1d)
            f.expand1d();
          else
            f.expand2d();
        } else {
          f.pb = f.refruns;
          f.b1 = static_cast<int32_t>(*f.pb++);
          f.expand2d();
          if (f.EOLcnt) throw Eof{};  // EOFB: libtiff fills this row and stops
        }
      } catch (const Eof&) {
        // libtiff fills this row and stops: Pillow keeps the strip, whose
        // later rows are its buffer's old memory, so only an end in the
        // last row's runs (after a first row) gives defined pixels
        fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
        if (expanding && line == rows - 1 && line > 0) return 0;
        return kind == kG4 && line > 0 ? -3 : -1;
      }
      fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
      if (kind == kRLE) {
        f.clr_bits(f.BitsAvail - (f.BitsAvail & ~7));
      } else if (kind == kRLEW) {
        f.clr_bits(f.BitsAvail - (f.BitsAvail & ~15));
        if (f.BitsAvail == 0 && ((f.cp - f.start) + f.base_parity) % 2) f.cp++;
      } else if (ref) {
        if (kind == kG4 || f.pa < f.thisrun + f.nruns) f.setvalue(0);  // imaginary change for reference
        uint32_t* t = f.curruns;
        f.curruns = f.refruns;
        f.refruns = t;
      }
    }
  } catch (const Overflow&) {
    return -2;
  }
  return 0;
}

}  // extern "C"

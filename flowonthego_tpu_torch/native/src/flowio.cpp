// Native runtime I/O layer of the PyTorch port (the port's own copy of
// the JAX package's framework-free source; it includes no framework).
//
// C++ counterpart of the host-side I/O the reference implementation does
// with OpenCV and custom writers (SaveFlowFile / ReadFlowFile, cv::imread +
// convertTo) and of the Middlebury evaluation colorizer (colorcode.cpp).
// Exposed as a C ABI for ctypes; all buffers are caller-owned.
//
// Numerics: images decode to float32 **BGR**, 0..255 — matching
// cv::imread(CV_LOAD_IMAGE_COLOR) + convertTo(CV_32F) so flow outputs are
// directly comparable with the reference.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

// A host without libpng or libjpeg builds with -DFLOWIO_NO_PNG and
// -DFLOWIO_NO_JPEG: .flo, PPM, the colour wheel and the frame stream
// still serve, and a PNG or JPEG path returns kNotBuilt.
#ifndef FLOWIO_NO_PNG
#include <png.h>
#endif
#ifndef FLOWIO_NO_JPEG
#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------- .flo I/O

static const float kFloTag = 202021.25f;  // reads as "PIEH"

// Returns 0 on success. Queries dimensions only when data == nullptr.
int flo_read(const char* path, int* width, int* height, float* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  float tag = 0.f;
  int w = 0, h = 0;
  if (std::fread(&tag, 4, 1, f) != 1 || tag != kFloTag ||
      std::fread(&w, 4, 1, f) != 1 || std::fread(&h, 4, 1, f) != 1 ||
      w <= 0 || h <= 0 || w > 99999 || h > 99999) {
    std::fclose(f);
    return -2;
  }
  *width = w;
  *height = h;
  if (data) {
    size_t n = (size_t)w * h * 2;
    if (std::fread(data, 4, n, f) != n) {
      std::fclose(f);
      return -3;
    }
  }
  std::fclose(f);
  return 0;
}

int flo_write(const char* path, int width, int height, const float* data) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fwrite("PIEH", 1, 4, f);
  std::fwrite(&width, 4, 1, f);
  std::fwrite(&height, 4, 1, f);
  size_t n = (size_t)width * height * 2;
  size_t wr = std::fwrite(data, 4, n, f);
  std::fclose(f);
  return wr == n ? 0 : -2;
}

// ------------------------------------------------------------ image decode

static const int kNotBuilt = -20;  // the format's decoder was left out

// Decode a PNG into float32 BGR (0..255). Pass data=nullptr to query size.
#ifdef FLOWIO_NO_PNG
int png_read_bgr32f(const char*, int*, int*, float*) { return kNotBuilt; }
#else
int png_read_bgr32f(const char* path, int* width, int* height, float* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  png_byte header[8];
  if (std::fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(f);
    return -2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return -3;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  *width = (int)w;
  *height = (int)h;
  if (!data) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return 0;
  }

  // Normalize to 8-bit RGB
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  png_bytep row = (png_bytep)std::malloc(png_get_rowbytes(png, info));
  for (png_uint_32 y = 0; y < h; y++) {
    png_read_row(png, row, nullptr);
    float* out = data + (size_t)y * w * 3;
    for (png_uint_32 x = 0; x < w; x++) {
      out[x * 3 + 0] = (float)row[x * 3 + 2];  // B
      out[x * 3 + 1] = (float)row[x * 3 + 1];  // G
      out[x * 3 + 2] = (float)row[x * 3 + 0];  // R
    }
  }
  std::free(row);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return 0;
}
#endif  // FLOWIO_NO_PNG

#ifdef FLOWIO_NO_JPEG
int jpeg_read_bgr32f(const char*, int*, int*, float*) { return kNotBuilt; }
#else
namespace {
// libjpeg's default error_exit calls exit(); longjmp back instead so a
// corrupt file returns an error code per the C-ABI contract.
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_longjmp(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}
}  // namespace

// Decode a JPEG into float32 BGR (0..255). Pass data=nullptr to query size.
int jpeg_read_bgr32f(const char* path, int* width, int* height, float* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_longjmp;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  *width = w;
  *height = h;
  if (!data) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 0;
  }
  JSAMPLE* row = (JSAMPLE*)std::malloc((size_t)w * 3);
  for (int y = 0; y < h; y++) {
    JSAMPROW rp = row;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* out = data + (size_t)y * w * 3;
    for (int x = 0; x < w; x++) {
      out[x * 3 + 0] = (float)row[x * 3 + 2];
      out[x * 3 + 1] = (float)row[x * 3 + 1];
      out[x * 3 + 2] = (float)row[x * 3 + 0];
    }
  }
  std::free(row);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}
#endif  // FLOWIO_NO_JPEG

// Dispatch on extension (.png / .jpg / .jpeg / .ppm).
int image_read_bgr32f(const char* path, int* width, int* height, float* data) {
  const char* dot = std::strrchr(path, '.');
  if (!dot) return -10;
  if (!std::strcmp(dot, ".png") || !std::strcmp(dot, ".PNG"))
    return png_read_bgr32f(path, width, height, data);
  if (!std::strcmp(dot, ".jpg") || !std::strcmp(dot, ".jpeg") ||
      !std::strcmp(dot, ".JPG"))
    return jpeg_read_bgr32f(path, width, height, data);
  if (!std::strcmp(dot, ".ppm")) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int w, h, maxv;
    if (std::fscanf(f, "P6 %d %d %d", &w, &h, &maxv) != 3 || maxv != 255) {
      std::fclose(f);
      return -2;
    }
    std::fgetc(f);
    *width = w;
    *height = h;
    if (data) {
      uint8_t* row = (uint8_t*)std::malloc((size_t)w * 3);
      for (int y = 0; y < h; y++) {
        if (std::fread(row, 1, (size_t)w * 3, f) != (size_t)w * 3) break;
        float* out = data + (size_t)y * w * 3;
        for (int x = 0; x < w; x++) {
          out[x * 3 + 0] = (float)row[x * 3 + 2];
          out[x * 3 + 1] = (float)row[x * 3 + 1];
          out[x * 3 + 2] = (float)row[x * 3 + 0];
        }
      }
      std::free(row);
    }
    std::fclose(f);
    return 0;
  }
  return -11;
}

// ------------------------------------------------------------ colorization

// Middlebury color wheel (colorcode.cpp:30-50): 55 colors.
static int make_wheel(uint8_t wheel[][3]) {
  const int RY = 15, YG = 6, GC = 4, CB = 11, BM = 13, MR = 6;
  int k = 0;
  for (int i = 0; i < RY; i++, k++) {
    wheel[k][0] = 255; wheel[k][1] = (uint8_t)(255 * i / RY); wheel[k][2] = 0;
  }
  for (int i = 0; i < YG; i++, k++) {
    wheel[k][0] = (uint8_t)(255 - 255 * i / YG); wheel[k][1] = 255; wheel[k][2] = 0;
  }
  for (int i = 0; i < GC; i++, k++) {
    wheel[k][0] = 0; wheel[k][1] = 255; wheel[k][2] = (uint8_t)(255 * i / GC);
  }
  for (int i = 0; i < CB; i++, k++) {
    wheel[k][0] = 0; wheel[k][1] = (uint8_t)(255 - 255 * i / CB); wheel[k][2] = 255;
  }
  for (int i = 0; i < BM; i++, k++) {
    wheel[k][0] = (uint8_t)(255 * i / BM); wheel[k][1] = 0; wheel[k][2] = 255;
  }
  for (int i = 0; i < MR; i++, k++) {
    wheel[k][0] = 255; wheel[k][1] = 0; wheel[k][2] = (uint8_t)(255 - 255 * i / MR);
  }
  return k;
}

// flow [h*w*2] -> RGB uint8 [h*w*3]; max_motion <= 0 -> auto-normalize.
void flow_to_color_rgb(const float* flow, int width, int height,
                       float max_motion, uint8_t* rgb) {
  static uint8_t wheel[64][3];
  static int ncols = 0;
  if (!ncols) ncols = make_wheel(wheel);

  float maxrad = max_motion;
  if (maxrad <= 0.f) {
    maxrad = 1e-9f;
    for (size_t i = 0; i < (size_t)width * height; i++) {
      float u = flow[2 * i], v = flow[2 * i + 1];
      if (std::fabs(u) > 1e9f || std::fabs(v) > 1e9f) continue;
      float r = std::sqrt(u * u + v * v);
      if (r > maxrad) maxrad = r;
    }
  }
  for (size_t i = 0; i < (size_t)width * height; i++) {
    float u = flow[2 * i], v = flow[2 * i + 1];
    if (std::fabs(u) > 1e9f || std::fabs(v) > 1e9f || u != u || v != v) {
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = 0;
      continue;
    }
    float fx = u / maxrad, fy = v / maxrad;
    float rad = std::sqrt(fx * fx + fy * fy);
    float a = std::atan2(-fy, -fx) / (float)M_PI;
    float fk = (a + 1.f) / 2.f * (ncols - 1);
    int k0 = (int)std::floor(fk);
    int k1 = (k0 + 1) % ncols;
    float fr = fk - k0;
    for (int c = 0; c < 3; c++) {
      float col0 = wheel[k0][c] / 255.f;
      float col1 = wheel[k1][c] / 255.f;
      float col = (1.f - fr) * col0 + fr * col1;
      if (rad <= 1.f)
        col = 1.f - rad * (1.f - col);
      else
        col *= 0.75f;
      rgb[3 * i + c] = (uint8_t)(255.f * col);
    }
  }
}

}  // extern "C"

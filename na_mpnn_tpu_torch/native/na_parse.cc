// Host-side structure tokenizer for the NA-MPNN PyTorch port's data path.
//
// Tokenizes ATOM/HETATM records (PDB) and atom_site rows (mmCIF), plain or
// gzipped, into flat column arrays that Python reads through ctypes. The
// pure-Python readers of data/pdb.py are its semantic reference.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libna_parse.so na_parse.cc -lz
// (driven automatically by na_mpnn_tpu_torch/data/native_loader.py)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct AtomColumns {
  std::vector<float> xyz;       // 3 per atom
  std::vector<float> occ;
  std::vector<float> bfac;
  std::vector<int32_t> resnum;
  std::vector<int32_t> serial;
  std::vector<char> name;       // 8 bytes per atom, NUL padded
  std::vector<char> resname;    // 8 bytes
  std::vector<char> chain;      // 4 bytes (mmCIF asym ids can be multi-char)
  std::vector<char> icode;      // 1 byte
  std::vector<char> element;    // 4 bytes
  std::vector<char> altloc;     // 1 byte
  std::vector<uint8_t> hetero;  // 1 = HETATM
  std::vector<int32_t> model;   // model number
};

struct ParseResult {
  AtomColumns cols;
  int64_t n = 0;
  std::string error;
};

void copy_fixed(std::vector<char>& dst, const char* src, size_t len,
                size_t width) {
  size_t start = dst.size();
  dst.resize(start + width, '\0');
  // strip spaces
  size_t b = 0, e = len;
  while (b < e && (src[b] == ' ' || src[b] == '\t')) b++;
  while (e > b && (src[e - 1] == ' ' || src[e - 1] == '\t' ||
                   src[e - 1] == '\r' || src[e - 1] == '\n')) e--;
  size_t m = e - b;
  if (m > width) m = width;
  memcpy(dst.data() + start, src + b, m);
}

float parse_float(const char* s, size_t len, float dflt) {
  char buf[32];
  size_t m = len < 31 ? len : 31;
  memcpy(buf, s, m);
  buf[m] = '\0';
  char* end = nullptr;
  float v = strtof(buf, &end);
  return end == buf ? dflt : v;
}

int32_t parse_int(const char* s, size_t len, int32_t dflt) {
  char buf[32];
  size_t m = len < 31 ? len : 31;
  memcpy(buf, s, m);
  buf[m] = '\0';
  char* end = nullptr;
  long v = strtol(buf, &end, 10);
  return end == buf ? dflt : static_cast<int32_t>(v);
}

bool read_file(const char* path, std::string* out) {
  // Transparent gzip support via zlib (handles plain files too).
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  char buf[1 << 16];
  int n;
  while ((n = gzread(f, buf, sizeof(buf))) > 0) out->append(buf, n);
  gzclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// PDB
// ---------------------------------------------------------------------------

void parse_pdb_text(const std::string& text, ParseResult* r,
                    int first_model_only) {
  AtomColumns& c = r->cols;
  size_t pos = 0, len = text.size();
  int32_t model = 1;
  bool saw_atoms = false;
  while (pos < len) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos) eol = len;
    const char* line = text.data() + pos;
    size_t ll = eol - pos;
    pos = eol + 1;
    if (ll < 6) continue;
    if (memcmp(line, "MODEL ", 6) == 0) {
      model = parse_int(line + 6, ll - 6, model);
      continue;
    }
    if (memcmp(line, "ENDMDL", 6) == 0) {
      if (first_model_only && saw_atoms) break;
      continue;
    }
    bool is_atom = memcmp(line, "ATOM  ", 6) == 0;
    bool is_het = memcmp(line, "HETATM", 6) == 0;
    if (!is_atom && !is_het) continue;
    if (ll < 54) continue;
    saw_atoms = true;
    c.serial.push_back(parse_int(line + 6, 5, 0));
    copy_fixed(c.name, line + 12, 4, 8);
    c.altloc.push_back(line[16]);
    copy_fixed(c.resname, line + 17, 3, 8);
    c.chain.push_back(line[21]);
    c.chain.push_back('\0');
    c.chain.push_back('\0');
    c.chain.push_back('\0');
    c.resnum.push_back(parse_int(line + 22, 4, 0));
    c.icode.push_back(ll > 26 ? line[26] : ' ');
    c.xyz.push_back(parse_float(line + 30, 8, 0.f));
    c.xyz.push_back(parse_float(line + 38, 8, 0.f));
    c.xyz.push_back(parse_float(line + 46, 8, 0.f));
    c.occ.push_back(ll >= 60 ? parse_float(line + 54, 6, 1.f) : 1.f);
    c.bfac.push_back(ll >= 66 ? parse_float(line + 60, 6, 0.f) : 0.f);
    if (ll >= 78) {
      copy_fixed(c.element, line + 76, 2, 4);
    } else {
      c.element.resize(c.element.size() + 4, '\0');
    }
    c.hetero.push_back(is_het ? 1 : 0);
    c.model.push_back(model);
    r->n++;
  }
}

// ---------------------------------------------------------------------------
// mmCIF atom_site
// ---------------------------------------------------------------------------

struct CifToken {
  const char* p;
  size_t len;
};

// Tokenize one mmCIF data line (space-separated, quote-aware).
size_t tokenize_cif_line(const char* line, size_t ll,
                         std::vector<CifToken>* toks) {
  toks->clear();
  size_t i = 0;
  while (i < ll) {
    while (i < ll && (line[i] == ' ' || line[i] == '\t')) i++;
    if (i >= ll || line[i] == '#') break;
    if (line[i] == '\'' || line[i] == '"') {
      char q = line[i];
      size_t j = i + 1;
      while (j < ll && !(line[j] == q &&
                         (j + 1 >= ll || line[j + 1] == ' ' ||
                          line[j + 1] == '\t')))
        j++;
      toks->push_back({line + i + 1, j - i - 1});
      i = j + 1;
    } else {
      size_t j = i;
      while (j < ll && line[j] != ' ' && line[j] != '\t') j++;
      toks->push_back({line + i, j - i});
      i = j;
    }
  }
  return toks->size();
}

void parse_cif_text(const std::string& text, ParseResult* r) {
  AtomColumns& c = r->cols;
  // Locate the atom_site loop header and column order.
  std::vector<std::string> columns;
  size_t pos = 0, len = text.size();
  bool in_atom_loop = false;
  int idx_group = -1, idx_id = -1, idx_atom = -1, idx_alt = -1, idx_comp = -1,
      idx_asym = -1, idx_seq = -1, idx_auth_seq = -1, idx_x = -1, idx_y = -1,
      idx_z = -1, idx_occ = -1, idx_b = -1, idx_sym = -1, idx_model = -1,
      idx_icode = -1, idx_auth_asym = -1;
  std::vector<CifToken> toks;
  bool header_done = false;
  while (pos < len) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos) eol = len;
    const char* line = text.data() + pos;
    size_t ll = eol - pos;
    pos = eol + 1;
    if (!in_atom_loop) {
      if (ll >= 11 && memcmp(line, "_atom_site.", 11) == 0) {
        in_atom_loop = true;
        columns.clear();
      } else {
        continue;
      }
    }
    if (in_atom_loop && !header_done) {
      if (ll >= 11 && memcmp(line, "_atom_site.", 11) == 0) {
        size_t e = 11;
        while (e < ll && line[e] != ' ' && line[e] != '\r') e++;
        columns.emplace_back(line + 11, e - 11);
        continue;
      }
      header_done = true;
      for (size_t k = 0; k < columns.size(); ++k) {
        const std::string& col = columns[k];
        if (col == "group_PDB") idx_group = k;
        else if (col == "id") idx_id = k;
        else if (col == "label_atom_id") idx_atom = k;
        else if (col == "label_alt_id") idx_alt = k;
        else if (col == "label_comp_id") idx_comp = k;
        else if (col == "label_asym_id") idx_asym = k;
        else if (col == "label_seq_id") idx_seq = k;
        else if (col == "auth_seq_id") idx_auth_seq = k;
        else if (col == "Cartn_x") idx_x = k;
        else if (col == "Cartn_y") idx_y = k;
        else if (col == "Cartn_z") idx_z = k;
        else if (col == "occupancy") idx_occ = k;
        else if (col == "B_iso_or_equiv") idx_b = k;
        else if (col == "type_symbol") idx_sym = k;
        else if (col == "pdbx_PDB_model_num") idx_model = k;
        else if (col == "pdbx_PDB_ins_code") idx_icode = k;
        else if (col == "auth_asym_id") idx_auth_asym = k;
      }
      (void)idx_auth_asym;
    }
    // data row (or end of loop)
    if (ll == 0 || line[0] == '#' || line[0] == '_' ||
        (ll >= 5 && memcmp(line, "loop_", 5) == 0)) {
      if (r->n > 0) break;  // finished the atom_site loop
      continue;
    }
    size_t ntok = tokenize_cif_line(line, ll, &toks);
    if ((int64_t)ntok < (int64_t)columns.size()) continue;
    auto tok = [&](int idx) -> CifToken {
      if (idx < 0 || idx >= (int)ntok) return {"", 0};
      return toks[idx];
    };
    CifToken g = tok(idx_group);
    bool is_atom = g.len == 4 && memcmp(g.p, "ATOM", 4) == 0;
    bool is_het = g.len == 6 && memcmp(g.p, "HETATM", 6) == 0;
    if (!is_atom && !is_het) continue;
    c.serial.push_back(parse_int(tok(idx_id).p, tok(idx_id).len, 0));
    copy_fixed(c.name, tok(idx_atom).p, tok(idx_atom).len, 8);
    CifToken alt = tok(idx_alt);
    c.altloc.push_back(alt.len == 0 || alt.p[0] == '.' || alt.p[0] == '?'
                           ? ' '
                           : alt.p[0]);
    copy_fixed(c.resname, tok(idx_comp).p, tok(idx_comp).len, 8);
    copy_fixed(c.chain, tok(idx_asym).p, tok(idx_asym).len, 4);
    // label_seq_id may be '.', fall back to auth_seq_id
    CifToken seq = tok(idx_seq);
    int32_t rn = (seq.len == 0 || seq.p[0] == '.' || seq.p[0] == '?')
                     ? parse_int(tok(idx_auth_seq).p, tok(idx_auth_seq).len,
                                 -999999)
                     : parse_int(seq.p, seq.len, -999999);
    c.resnum.push_back(rn);
    CifToken ic = tok(idx_icode);
    c.icode.push_back(ic.len == 0 || ic.p[0] == '.' || ic.p[0] == '?' ? ' '
                                                                      : ic.p[0]);
    c.xyz.push_back(parse_float(tok(idx_x).p, tok(idx_x).len, 0.f));
    c.xyz.push_back(parse_float(tok(idx_y).p, tok(idx_y).len, 0.f));
    c.xyz.push_back(parse_float(tok(idx_z).p, tok(idx_z).len, 0.f));
    c.occ.push_back(idx_occ >= 0 ? parse_float(tok(idx_occ).p, tok(idx_occ).len, 1.f)
                                 : 1.f);
    c.bfac.push_back(idx_b >= 0 ? parse_float(tok(idx_b).p, tok(idx_b).len, 0.f)
                                : 0.f);
    copy_fixed(c.element, tok(idx_sym).p, tok(idx_sym).len, 4);
    c.hetero.push_back(is_het ? 1 : 0);
    c.model.push_back(idx_model >= 0
                          ? parse_int(tok(idx_model).p, tok(idx_model).len, 1)
                          : 1);
    r->n++;
  }
}

}  // namespace

extern "C" {

// Opaque handle API: parse once, copy columns out, free.
void* na_parse_structure(const char* path, int is_cif, int first_model_only) {
  auto* r = new ParseResult();
  std::string text;
  if (!read_file(path, &text)) {
    r->error = "cannot open file";
    return r;
  }
  if (is_cif)
    parse_cif_text(text, r);
  else
    parse_pdb_text(text, r, first_model_only);
  return r;
}

int64_t na_parse_num_atoms(void* handle) {
  return static_cast<ParseResult*>(handle)->n;
}

const char* na_parse_error(void* handle) {
  return static_cast<ParseResult*>(handle)->error.c_str();
}

// Copy the parsed columns into caller-provided buffers (sized by
// na_parse_num_atoms): xyz[f32 n*3], occ[f32 n], bfac[f32 n], resnum[i32 n],
// serial[i32 n], name[u8 n*8], resname[u8 n*8], chain[u8 n*4], icode[u8 n],
// element[u8 n*4], altloc[u8 n], hetero[u8 n], model[i32 n].
void na_parse_copy(void* handle, float* xyz, float* occ, float* bfac,
                   int32_t* resnum, int32_t* serial, char* name, char* resname,
                   char* chain, char* icode, char* element, char* altloc,
                   uint8_t* hetero, int32_t* model) {
  auto* r = static_cast<ParseResult*>(handle);
  const AtomColumns& c = r->cols;
  int64_t n = r->n;
  if (n == 0) return;
  memcpy(xyz, c.xyz.data(), n * 3 * sizeof(float));
  memcpy(occ, c.occ.data(), n * sizeof(float));
  memcpy(bfac, c.bfac.data(), n * sizeof(float));
  memcpy(resnum, c.resnum.data(), n * sizeof(int32_t));
  memcpy(serial, c.serial.data(), n * sizeof(int32_t));
  memcpy(name, c.name.data(), n * 8);
  memcpy(resname, c.resname.data(), n * 8);
  memcpy(chain, c.chain.data(), n * 4);
  memcpy(icode, c.icode.data(), n);
  memcpy(element, c.element.data(), n * 4);
  memcpy(altloc, c.altloc.data(), n);
  memcpy(hetero, c.hetero.data(), n);
  memcpy(model, c.model.data(), n * sizeof(int32_t));
}

void na_parse_free(void* handle) { delete static_cast<ParseResult*>(handle); }

}  // extern "C"

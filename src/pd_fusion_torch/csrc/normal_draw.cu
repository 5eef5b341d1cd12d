// numpy's normal draw, bit for bit, on Hopper (sm_90a): kernel K3.
//
// Replaces no Pallas kernel. The fine-tune's augmentation noise (4 x 64 x
// 160^2 values a step or a TTA pass) was drawn on the host by numpy,
// rng.normal(0, std, shape) over a PCG64 Generator, in 0.15-0.19 s, on the
// preparation thread, which then paced three of the benchmark's five cells
// (PERF.md). The benchmark's reference and the JAX-equivalence tests replay
// numpy's stream, so this kernel computes that stream itself: the values
// are numpy's own, and the host moves its generator past the outputs the
// draw consumed. Wrapper, the algorithm's description and the plain version
// (numpy): ops/normal_draw.py.
//
// What bounds it on an H100: bytes, and not many. Each position of the
// stream costs a 128-bit LCG step (a few 64-bit multiplies) and a handful
// of double operations; the passes below move about 23 bytes a position
// (value and attempt written, the attempt read three times, a skip flag,
// the output), 154 MB for the 6.7 M positions of a 6.55 M draw: 46 us at
// 3.35 TB/s; the output alone is 26 MB, 7.8 us. Five launches.
//
// Design.
// - k3_attempts: each thread takes 16 positions 256 apart, so a warp's
//   stores are contiguous. It jumps the LCG to its first position (the
//   binary jump-ahead, about 23 squarings), then steps 256 positions at a
//   time with the 256-step map, which costs one step. At each position it
//   runs numpy's whole attempt from there: the fast test, or the wedge's
//   one more output, or the tail's pairs, stepping a copy of the state by
//   one. It writes the value the attempt would yield, rounded to float,
//   and the attempt as a 16-bit word: its length in outputs and a yield
//   bit. The longest attempt goes to meta[kLongest] (an integer max).
//   ki and wi sit in shared memory (the index is random across a warp,
//   which constant memory serializes); fi is read rarely, through L1.
// - k3_resolve: a position whose attempt is longer than one output and
//   which no earlier attempt reaches past (a look-back of kLongest - 1
//   positions) lies on the chain; its thread walks the chain from there,
//   marking the positions inside each attempt as skipped, until a chain
//   position is clear again. Walks never overlap, and they are short:
//   about 1.5% of positions start a longer attempt, and a cluster of them
//   within each other's reach is rare.
// - k3_count, k3_scan, k3_write: each block of 256 threads counts the
//   yielding chain positions of a tile of 4096 (16 consecutive a thread,
//   vector loads), one block scans the tiles' counts, and each tile scans
//   its threads' counts and writes its values through shared memory to
//   out[offset ...], the first n; the thread holding value n - 1 writes
//   the end of its attempt to meta[kConsumed]. meta[kTotal] tells the
//   wrapper that the budget yielded n values; if not, it draws again with
//   a larger budget, which gives the same stream.
// - No float atomics, no order that varies: a draw gives the same bits on
//   every run.
//
// Exactness. numpy's expressions, each operation rounded alone (no FMA:
// the __dmul_rn / __dadd_rn intrinsics are never contracted):
//   x = +-rabs * wi[idx]; the wedge (fi[idx-1] - fi[idx]) * u + fi[idx] <
//   exp((-0.5 * x) * x); the tail xx = -inv_r * log1p(-u1), yy =
//   -log1p(-u2), yy + yy > xx * xx; u = (output >> 11) * 2^-53; the value
//   float(loc + scale * x). CUDA's double exp and log1p are within an ulp
//   of the C library's that numpy calls, not equal to it: a wedge or tail
//   test whose two sides lie within that ulp could take the other branch.
//   That is the one way these bits could part from numpy's; no draw
//   compared has shown it (PERF.md).
//
// The tables below are numpy's ki_double, wi_double and fi_double (the
// doubles by their bits), read from the static library numpy installs,
// numpy/random/lib/libnpyrandom.a, by csrc/ziggurat_tables.py, which
// prints this block. ops/normal_draw.py's plain version reads them here.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ const unsigned long long kKi[256] = {
    0x000ef33d8025ef6aull, 0x0000000000000000ull, 0x000c08be98fbc6a8ull, 0x000da354fabd8142ull,
    0x000e51f67ec1eeeaull, 0x000eb255e9d3f77eull, 0x000eef4b817ecab9ull, 0x000f19470afa44aaull,
    0x000f37ed61ffcb18ull, 0x000f4f469561255cull, 0x000f61a5e41ba396ull, 0x000f707a755396a4ull,
    0x000f7cb2ec28449aull, 0x000f86f10c6357d3ull, 0x000f8fa6578325deull, 0x000f9724c74dd0daull,
    0x000f9da907dbf509ull, 0x000fa360f581fa74ull, 0x000fa86fde5b4bf8ull, 0x000facf160d354dcull,
    0x000fb0fb6718b90full, 0x000fb49f8d5374c6ull, 0x000fb7ec2366fe77ull, 0x000fbaece9a1e50eull,
    0x000fbdab9d040bedull, 0x000fc03060ff6c57ull, 0x000fc2821037a248ull, 0x000fc4a67ae25bd1ull,
    0x000fc6a2977aee31ull, 0x000fc87aa92896a4ull, 0x000fca325e4bde85ull, 0x000fcbcce902231aull,
    0x000fcd4d12f839c4ull, 0x000fceb54d8fec99ull, 0x000fd007bf1dc930ull, 0x000fd1464dd6c4e6ull,
    0x000fd272a8e2f450ull, 0x000fd38e4ff0c91eull, 0x000fd49a9990b478ull, 0x000fd598b8920f53ull,
    0x000fd689c08e99ecull, 0x000fd76ea9c8e832ull, 0x000fd848547b08e8ull, 0x000fd9178bad2c8cull,
    0x000fd9dd07a7add2ull, 0x000fda9970105e8cull, 0x000fdb4d5dc02e20ull, 0x000fdbf95c5bfcd0ull,
    0x000fdc9debb99a7dull, 0x000fdd3b8118729dull, 0x000fddd288342f90ull, 0x000fde6364369f64ull,
    0x000fdeee708d514eull, 0x000fdf7401a6b42eull, 0x000fdff46599ed40ull, 0x000fe06fe4bc24f2ull,
    0x000fe0e6c225a258ull, 0x000fe1593c28b84cull, 0x000fe1c78cbc3f99ull, 0x000fe231e9db1caaull,
    0x000fe29885da1b91ull, 0x000fe2fb8fb54186ull, 0x000fe35b33558d4aull, 0x000fe3b799d0002aull,
    0x000fe410e99ead7full, 0x000fe46746d47734ull, 0x000fe4bad34c095cull, 0x000fe50baed29524ull,
    0x000fe559f74ebc78ull, 0x000fe5a5c8e41212ull, 0x000fe5ef3e138689ull, 0x000fe6366fd91078ull,
    0x000fe67b75c6d578ull, 0x000fe6be661e11aaull, 0x000fe6ff55e5f4f2ull, 0x000fe73e5900a702ull,
    0x000fe77b823e9e39ull, 0x000fe7b6e37070a2ull, 0x000fe7f08d774243ull, 0x000fe8289053f08cull,
    0x000fe85efb35173aull, 0x000fe893dc840864ull, 0x000fe8c741f0cebcull, 0x000fe8f9387d4ef6ull,
    0x000fe929cc879b1dull, 0x000fe95909d388eaull, 0x000fe986fb939aa2ull, 0x000fe9b3ac714866ull,
    0x000fe9df2694b6d5ull, 0x000fea0973abe67cull, 0x000fea329cf166a4ull, 0x000fea5aab32952cull,
    0x000fea81a6d5741aull, 0x000feaa797de1cf0ull, 0x000feacc85f3d920ull, 0x000feaf07865e63cull,
    0x000feb13762fec13ull, 0x000feb3585fe2a4aull, 0x000feb56ae3162b4ull, 0x000feb76f4e284faull,
    0x000feb965fe62014ull, 0x000febb4f4cf9d7cull, 0x000febd2b8f449d0ull, 0x000febefb16e2e3eull,
    0x000fec0be31ebde8ull, 0x000fec2752b15a15ull, 0x000fec42049dafd3ull, 0x000fec5bfd29f196ull,
    0x000fec75406ceef4ull, 0x000fec8dd2500cb4ull, 0x000feca5b6911f12ull, 0x000fecbcf0c427feull,
    0x000fecd38454fb15ull, 0x000fece97488c8b3ull, 0x000fecfec47f91b7ull, 0x000fed1377358528ull,
    0x000fed278f844903ull, 0x000fed3b10242f4cull, 0x000fed4dfbad586eull, 0x000fed605498c3ddull,
    0x000fed721d414fe8ull, 0x000fed8357e4a982ull, 0x000fed9406a42cc8ull, 0x000feda42b85b704ull,
    0x000fedb3c8746ab4ull, 0x000fedc2df416652ull, 0x000fedd171a46e52ull, 0x000feddf813c8ad3ull,
    0x000feded0f909980ull, 0x000fedfa1e0fd414ull, 0x000fee06ae124bc4ull, 0x000fee12c0d95a06ull,
    0x000fee1e579006e0ull, 0x000fee29734b6524ull, 0x000fee34150ae4bcull, 0x000fee3e3db89b3cull,
    0x000fee47ee2982f4ull, 0x000fee51271db086ull, 0x000fee59e9407f41ull, 0x000fee623528b42eull,
    0x000fee6a0b5897f1ull, 0x000fee716c3e077aull, 0x000fee7858327b82ull, 0x000fee7ecf7b06baull,
    0x000fee84d2484ab2ull, 0x000fee8a60b66343ull, 0x000fee8f7accc851ull, 0x000fee94207e25daull,
    0x000fee9851a829eaull, 0x000fee9c0e13485cull, 0x000fee9f557273f4ull, 0x000feea22762ccaeull,
    0x000feea4836b42acull, 0x000feea668fc2d71ull, 0x000feea7d76ed6faull, 0x000feea8ce04fa0aull,
    0x000feea94be8333bull, 0x000feea950296410ull, 0x000feea8d9c0075eull, 0x000feea7e7897654ull,
    0x000feea678481d24ull, 0x000feea48aa29e83ull, 0x000feea21d22e4daull, 0x000fee9f2e352024ull,
    0x000fee9bbc26af2eull, 0x000fee97c524f2e4ull, 0x000fee93473c0a3aull, 0x000fee8e40557516ull,
    0x000fee88ae369c7aull, 0x000fee828e7f3dfdull, 0x000fee7bdea7b888ull, 0x000fee749bff37ffull,
    0x000fee6cc3a9bd5eull, 0x000fee64529e007eull, 0x000fee5b45a32888ull, 0x000fee51994e57b6ull,
    0x000fee474a0006cfull, 0x000fee3c53e12c50ull, 0x000fee30b2e02ad8ull, 0x000fee2462ad8205ull,
    0x000fee175eb83c5aull, 0x000fee09a22a1447ull, 0x000fedfb27e349ccull, 0x000fedebea76216cull,
    0x000feddbe422047eull, 0x000fedcb0ece39d3ull, 0x000fedb964042cf4ull, 0x000feda6dce938c9ull,
    0x000fed937237e98dull, 0x000fed7f1c38a836ull, 0x000fed69d2b9c02bull, 0x000fed538d06ae00ull,
    0x000fed3c41dea422ull, 0x000fed23e76a2fd8ull, 0x000fed0a732fe644ull, 0x000fecefda07fe34ull,
    0x000fecd4100eb7b8ull, 0x000fecb708956eb4ull, 0x000fec98b61230c1ull, 0x000fec790a0da978ull,
    0x000fec57f50f31feull, 0x000fec356686c962ull, 0x000fec114cb4b335ull, 0x000febeb948e6fd0ull,
    0x000febc429a0b692ull, 0x000feb9af5ee0cdcull, 0x000feb6fe1c98542ull, 0x000feb42d3ad1f9eull,
    0x000feb13b00b2d4bull, 0x000feae2591a02e9ull, 0x000feaaeae992257ull, 0x000fea788d8ee326ull,
    0x000fea3fcffd73e5ull, 0x000fea044c8dd9f6ull, 0x000fe9c5d62f563bull, 0x000fe9843ba947a4ull,
    0x000fe93f471d4728ull, 0x000fe8f6bd76c5d6ull, 0x000fe8aa5dc4e8e6ull, 0x000fe859e07ab1eaull,
    0x000fe804f690a940ull, 0x000fe7ab488233c0ull, 0x000fe74c751f6aa5ull, 0x000fe6e8102aa202ull,
    0x000fe67da0b6abd8ull, 0x000fe60c9f38307eull, 0x000fe5947338f742ull, 0x000fe51470977280ull,
    0x000fe48bd436f458ull, 0x000fe3f9bffd1e37ull, 0x000fe35d35eeb19cull, 0x000fe2b5122fe4feull,
    0x000fe20003995557ull, 0x000fe13c82788314ull, 0x000fe068c4ee67b0ull, 0x000fdf82b02b71aaull,
    0x000fde87c57efeaaull, 0x000fdd7509c63bfdull, 0x000fdc46e529bf13ull, 0x000fdaf8f82e0282ull,
    0x000fd985e1b2ba75ull, 0x000fd7e6ef48cf04ull, 0x000fd613adbd650bull, 0x000fd40149e2f012ull,
    0x000fd1a1a7b4c7acull, 0x000fcee204761f9eull, 0x000fcba8d85e11b2ull, 0x000fc7d26ecd2d22ull,
    0x000fc32b2f1e22edull, 0x000fbd6581c0b83aull, 0x000fb606c4005434ull, 0x000fac40582a2874ull,
    0x000f9e971e014598ull, 0x000f89fa48a41dfcull, 0x000f66c5f7f0302cull, 0x000f1a5a4b331c4aull,
};
__device__ const unsigned long long kWiBits[256] = {
    0x3ccf493b7815d979ull, 0x3c8b8d0be3fdf6c6ull, 0x3c9250af3c2c5bb4ull, 0x3c957cb938443b61ull,
    0x3c9801fce82fa70cull, 0x3c9a230c2e4cd0bcull, 0x3c9c004d2f3861f7ull, 0x3c9dac2f5a747274ull,
    0x3c9f32482d4cd5c3ull, 0x3ca04d32278ebbadull, 0x3ca0f5053b025d43ull, 0x3ca192a697413677ull,
    0x3ca227a28f7a1af5ull, 0x3ca2b52e3863d880ull, 0x3ca33c3fc05791f5ull, 0x3ca3bd9ec1a2b12full,
    0x3ca439ef8dff9b55ull, 0x3ca4b1bb363dfea7ull, 0x3ca52575621ad374ull, 0x3ca59580a707ce96ull,
    0x3ca60231cfd97eeaull, 0x3ca66bd261a37c3dull, 0x3ca6d2a292000570ull, 0x3ca736dad346f8a6ull,
    0x3ca798ad10b32a77ull, 0x3ca7f845ad46f543ull, 0x3ca855cc53430a77ull, 0x3ca8b1649e7b769aull,
    0x3ca90b2ea94ecf98ull, 0x3ca96347822c1eeaull, 0x3ca9b9c98e38c546ull, 0x3caa0eccdca4a72cull,
    0x3caa62676d77cd59ull, 0x3caab4ad6e101630ull, 0x3cab05b16d136c9cull, 0x3cab558487427a29ull,
    0x3caba4368e529f3aull, 0x3cabf1d62abf8232ull, 0x3cac3e70f9594ef3ull, 0x3cac8a13a5323b61ull,
    0x3cacd4c9fe72268bull, 0x3cad1e9f0e80b748ull, 0x3cad679d29e41f10ull, 0x3cadafce0023b8c3ull,
    0x3cadf73aa9f17653ull, 0x3cae3debb5d2edfeull, 0x3cae83e9337a6f00ull, 0x3caec93abdf982ceull,
    0x3caf0de784f06226ull, 0x3caf51f654d8f688ull, 0x3caf956d9e87d7aeull, 0x3cafd8537dfa2eacull,
    0x3cb00d56e04234ecull, 0x3cb02e40f5398f9aull, 0x3cb04eea9e16a5fcull, 0x3cb06f565b72a010ull,
    0x3cb08f869071f40bull, 0x3cb0af7d84bc6113ull, 0x3cb0cf3d664bcc7full, 0x3cb0eec84b16086bull,
    0x3cb10e20329515eeull, 0x3cb12d4707310fbeull, 0x3cb14c3e9f8e9141ull, 0x3cb16b08bfc4201eull,
    0x3cb189a71a78da34ull, 0x3cb1a81b51ee6d88ull, 0x3cb1c666f8f82acbull, 0x3cb1e48b93e0d42eull,
    0x3cb2028a9940a09full, 0x3cb2206572c4c6e9ull, 0x3cb23e1d7de9c31full, 0x3cb25bb40ca96bfbull,
    0x3cb2792a661dd37full, 0x3cb29681c719d71bull, 0x3cb2b3bb62b82edaull, 0x3cb2d0d862e1b853ull,
    0x3cb2edd9e8cba98eull, 0x3cb30ac10d6e48d7ull, 0x3cb3278ee1f4b930ull, 0x3cb3444470265ea1ull,
    0x3cb360e2baca52d5ull, 0x3cb37d6abe05586aull, 0x3cb399dd6fb2b264ull, 0x3cb3b63bbfb83d03ull,
    0x3cb3d28698561de0ull, 0x3cb3eebede725a83ull, 0x3cb40ae571e09e74ull, 0x3cb426fb2da6745dull,
    0x3cb44300e83c30a4ull, 0x3cb45ef773cac75dull, 0x3cb47adf9e66c336ull, 0x3cb496ba32488f2full,
    0x3cb4b287f602415dull, 0x3cb4ce49acb311dcull, 0x3cb4ea001638a605ull, 0x3cb505abef5e5562ull,
    0x3cb5214df20a8b5aull, 0x3cb53ce6d56a664full, 0x3cb558774e1bb2c8ull, 0x3cb574000e555f78ull,
    0x3cb58f81c60e8514ull, 0x3cb5aafd23241b59ull, 0x3cb5c672d17d733dull, 0x3cb5e1e37b2f8cd3ull,
    0x3cb5fd4fc89f5e38ull, 0x3cb618b860a31fc3ull, 0x3cb6341de8a2b0a2ull, 0x3cb64f8104b7260bull,
    0x3cb66ae257c99672ull, 0x3cb6864283b13137ull, 0x3cb6a1a22950b2b1ull, 0x3cb6bd01e8b343bbull,
    0x3cb6d8626128d352ull, 0x3cb6f3c43161f854ull, 0x3cb70f27f78b68ebull, 0x3cb72a8e516914c6ull,
    0x3cb745f7dc70eedcull, 0x3cb7616535e5731full, 0x3cb77cd6faeff449ull, 0x3cb7984dc8babd93ull,
    0x3cb7b3ca3c8b1409ull, 0x3cb7cf4cf3db22fbull, 0x3cb7ead68c73dee7ull, 0x3cb80667a486ea1full,
    0x3cb82200dac88676ull, 0x3cb83da2ce899f15ull, 0x3cb8594e1fd1f5bdull, 0x3cb875036f7a7ec5ull,
    0x3cb890c35f47f72dull, 0x3cb8ac8e9205c043ull, 0x3cb8c865aba10c9cull, 0x3cb8e44951446a27ull,
    0x3cb9003a2973b58full, 0x3cb91c38dc288347ull, 0x3cb9384612ef0afcull, 0x3cb954627903a28aull,
    0x3cb9708ebb70d5eeull, 0x3cb98ccb892e2a31ull, 0x3cb9a919933f99bfull, 0x3cb9c5798cd5d92cull,
    0x3cb9e1ec2b6f7411ull, 0x3cb9fe7226fad24aull, 0x3cba1b0c39f93692ull, 0x3cba37bb21a2c85bull,
    0x3cba547f9e0bbb88ull, 0x3cba715a724aa9a4ull, 0x3cba8e4c64a0313dull, 0x3cbaab563e9ff108ull,
    0x3cbac878cd5af5ceull, 0x3cbae5b4e18bb336ull, 0x3cbb030b4fc3a11aull, 0x3cbb207cf09a985bull,
    0x3cbb3e0aa0e00c00ull, 0x3cbb5bb541ce3d03ull, 0x3cbb797db93f8927ull, 0x3cbb9764f1e5f73cull,
    0x3cbbb56bdb85256eull, 0x3cbbd3936b2ec0a2ull, 0x3cbbf1dc9b81ae83ull, 0x3cbc10486cec16a0ull,
    0x3cbc2ed7e5f07a2dull, 0x3cbc4d8c136e0d1cull, 0x3cbc6c6608ec8705ull, 0x3cbc8b66e0eba617ull,
    0x3cbcaa8fbd36a2abull, 0x3cbcc9e1c73bd690ull, 0x3cbce95e3068e037ull, 0x3cbd0906328b8f6eull,
    0x3cbd28db1037ef20ull, 0x3cbd48de1533c647ull, 0x3cbd691096e7f123ull, 0x3cbd8973f4d7fba5ull,
    0x3cbdaa0999206e70ull, 0x3cbdcad2f8fc490eull, 0x3cbdebd195522e37ull, 0x3cbe0d06fb49d21cull,
    0x3cbe2e74c4ea46f6ull, 0x3cbe501c99c1d188ull, 0x3cbe72002f97fe25ull, 0x3cbe94214b2abf0aull,
    0x3cbeb681c0f76f08ull, 0x3cbed9237610a73aull, 0x3cbefc086101eca9ull, 0x3cbf1f328ac25321ull,
    0x3cbf42a40fb74d6dull, 0x3cbf665f20c90168ull, 0x3cbf8a6604899782ull, 0x3cbfaebb187122bfull,
    0x3cbfd360d22fe785ull, 0x3cbff859c118f60bull, 0x3cc00ed447d3a075ull, 0x3cc021a8028fc947ull,
    0x3cc034a983a902abull, 0x3cc047da4e3ef5c7ull, 0x3cc05b3bf6adb37eull, 0x3cc06ed023a72668ull,
    0x3cc082988f632e17ull, 0x3cc0969708e8a254ull, 0x3cc0aacd7571c0c4ull, 0x3cc0bf3dd1eed448ull,
    0x3cc0d3ea34aa3d30ull, 0x3cc0e8d4cf116593ull, 0x3cc0fdffefa69fb6ull, 0x3cc1136e04207041ull,
    0x3cc129219bbb5d35ull, 0x3cc13f1d69c4096dull, 0x3cc1556448602e3bull, 0x3cc16bf93b9deef3ull,
    0x3cc182df74d21261ull, 0x3cc19a1a564eebacull, 0x3cc1b1ad777f2f8eull, 0x3cc1c99ca971a694ull,
    0x3cc1e1ebfbe4ae39ull, 0x3cc1fa9fc2e2d901ull, 0x3cc213bc9d04cc81ull, 0x3cc22d477a6fd3eeull,
    0x3cc24745a4ac9c24ull, 0x3cc261bcc77658e0ull, 0x3cc27cb2faa8592eull, 0x3cc2982ecd770e78ull,
    0x3cc2b437532a0a52ull, 0x3cc2d0d43196db97ull, 0x3cc2ee0db1a978f5ull, 0x3cc30becd256aeeeull,
    0x3cc32a7b5e68a4a3ull, 0x3cc349c405ae12a3ull, 0x3cc369d27a33a840ull, 0x3cc38ab39256410aull,
    0x3cc3ac7570ae88faull, 0x3cc3cf27b31704a6ull, 0x3cc3f2dbaa60f475ull, 0x3cc417a49cb9e5daull,
    0x3cc43d9815545e94ull, 0x3cc464ce44a73a15ull, 0x3cc48d62759c43bcull, 0x3cc4b7739d6b5a27ull,
    0x3cc4e3250dcd8902ull, 0x3cc5109f53e9ac41ull, 0x3cc54011523a7e42ull, 0x3cc571b1a94ae41bull,
    0x3cc5a5c08b718dd9ull, 0x3cc5dc8a243ad0feull, 0x3cc61669cf861e4cull, 0x3cc653ce7b006aeaull,
    0x3cc69540be9fe5c3ull, 0x3cc6db6b8d09e232ull, 0x3cc72728f05f7a34ull, 0x3cc7799556090673ull,
    0x3cc7d42df4d6ce8cull, 0x3cc839030529f234ull, 0x3cc8ab0fbfaa7c14ull, 0x3cc92ee0946f4496ull,
    0x3cc9cbee014057abull, 0x3cca8fdc7894775aull, 0x3ccb981f3878fdb1ull, 0x3ccd3bb48209ad33ull,
};
__device__ const unsigned long long kFiBits[256] = {
    0x3ff0000000000000ull, 0x3fef446ac979f087ull, 0x3feeb7545b6ca915ull, 0x3fee3f11e027f077ull,
    0x3fedd36fa704de95ull, 0x3fed70920657bcf2ull, 0x3fed144978a119dcull, 0x3fecbd33a8a72debull,
    0x3fec6a5ecea9787full, 0x3fec1b1cd9eebaeaull, 0x3febceeb4ee1dc82ull, 0x3feb85653a8ff552ull,
    0x3feb3e3a8234dd10ull, 0x3feaf92a3f6ce8a2ull, 0x3feab5fef17a2504ull, 0x3fea748bd550c9e1ull,
    0x3fea34aafdf5af0full, 0x3fe9f63bee651fd8ull, 0x3fe9b9228d240681ull, 0x3fe97d4657617ac1ull,
    0x3fe94291c21b7a47ull, 0x3fe908f1bd31714full, 0x3fe8d0554fe60aa8ull, 0x3fe898ad48badf02ull,
    0x3fe861ebfc37bcacull, 0x3fe82c050f56cf6eull, 0x3fe7f6ed4b20e2cbull, 0x3fe7c29a779c6858ull,
    0x3fe78f033ca0b0d5ull, 0x3fe75c1f0770d856ull, 0x3fe729e5f43f6d12ull, 0x3fe6f850baea7aeeull,
    0x3fe6c7589e635a89ull, 0x3fe696f75e513b2aull, 0x3fe667272a92e323ull, 0x3fe637e298550c18ull,
    0x3fe6092498802665ull, 0x3fe5dae86f4aff6aull, 0x3fe5ad29acc85c89ull, 0x3fe57fe4264c8d8full,
    0x3fe55313f08d9e46ull, 0x3fe526b55a656cd5ull, 0x3fe4fac4e820b667ull, 0x3fe4cf3f4f494ec0ull,
    0x3fe4a42172dc5278ull, 0x3fe479685fdf5012ull, 0x3fe44f114a493679ull, 0x3fe425198a355fe3ull,
    0x3fe3fb7e99585b82ull, 0x3fe3d23e10af31a3ull, 0x3fe3a955a662cd0eull, 0x3fe380c32bda00d5ull,
    0x3fe358848bf550e9ull, 0x3fe33097c9703a35ull, 0x3fe308fafd6438efull, 0x3fe2e1ac55ea3beeull,
    0x3fe2baaa14d7954aull, 0x3fe293f28e93cd15ull, 0x3fe26d84290504edull, 0x3fe2475d5a90db84ull,
    0x3fe2217ca92ff7f2ull, 0x3fe1fbe0a9929620ull, 0x3fe1d687fe549969ull, 0x3fe1b171573fd111ull,
    0x3fe18c9b709b3c50ull, 0x3fe16805128639daull, 0x3fe143ad105ea99cull, 0x3fe11f9248311f38ull,
    0x3fe0fbb3a2325913ull, 0x3fe0d810104142a0ull, 0x3fe0b4a68d70d9aeull, 0x3fe091761d995d81ull,
    0x3fe06e7dccf03c36ull, 0x3fe04bbcafa63f2eull, 0x3fe02931e18b822aull, 0x3fe006dc85b8cac4ull,
    0x3fdfc9778c7bbda1ull, 0x3fdf859da7a900caull, 0x3fdf4229cb2f7af3ull, 0x3fdeff1a717e8f95ull,
    0x3fdebc6e20bd1f54ull, 0x3fde7a236a4ec3c5ull, 0x3fde3838ea5f9b85ull, 0x3fddf6ad47763a09ull,
    0x3fddb57f320b56b1ull, 0x3fdd74ad6426de33ull, 0x3fdd3436a1021080ull, 0x3fdcf419b4ae5b6dull,
    0x3fdcb45573c0a848ull, 0x3fdc74e8bb00d7c7ull, 0x3fdc35d26f1d2cb8ull, 0x3fdbf7117c616a17ull,
    0x3fdbb8a4d6716d91ull, 0x3fdb7a8b7807131bull, 0x3fdb3cc462b331caull, 0x3fdaff4e9ea18552ull,
    0x3fdac2293a5f5a9eull, 0x3fda85534aa4d880ull, 0x3fda48cbea20c04dull, 0x3fda0c923946843eull,
    0x3fd9d0a55e1e93dfull, 0x3fd995048418c0c6ull, 0x3fd959aedbe09f93ull, 0x3fd91ea39b33cb17ull,
    0x3fd8e3e1fcb9f115ull, 0x3fd8a9693fde9188ull, 0x3fd86f38a8ac5ab6ull, 0x3fd8354f7faa0dd9ull,
    0x3fd7fbad11b8d911ull, 0x3fd7c250aff414b0ull, 0x3fd78939af9252ebull, 0x3fd7506769c7b1edull,
    0x3fd717d93ba9614cull, 0x3fd6df8e86124caaull, 0x3fd6a786ad88de21ull, 0x3fd66fc11a25cbe2ull,
    0x3fd6383d377be515ull, 0x3fd600fa7480d2c8ull, 0x3fd5c9f84376c244ull, 0x3fd5933619d6eebeull,
    0x3fd55cb3703d0100ull, 0x3fd5266fc2533bedull, 0x3fd4f06a8ebf6d92ull, 0x3fd4baa357109ca2ull,
    0x3fd485199fad6ad4ull, 0x3fd44fccefc324feull, 0x3fd41abcd1357a19ull, 0x3fd3e5e8d08ed2dbull,
    0x3fd3b1507cf143aeull, 0x3fd37cf368081379ull, 0x3fd348d125f9d19eull, 0x3fd314e94d5af62full,
    0x3fd2e13b77210766ull, 0x3fd2adc73e963fddull, 0x3fd27a8c414db11eull, 0x3fd2478a1f17de89ull,
    0x3fd214c079f7cc9eull, 0x3fd1e22ef6188116ull, 0x3fd1afd539c2f050ull, 0x3fd17db2ed5454e8ull,
    0x3fd14bc7bb34ee67ull, 0x3fd11a134fcf2423ull, 0x3fd0e895598709c4ull, 0x3fd0b74d88b242daull,
    0x3fd0863b8f904336ull, 0x3fd0555f2242e9d9ull, 0x3fd024b7f6c7747eull, 0x3fcfe88b89df93c5ull,
    0x3fcf88108cb83235ull, 0x3fcf27fe6ce998d2ull, 0x3fcec854a4c99c44ull, 0x3fce6912b2283cddull,
    0x3fce0a3816457184ull, 0x3fcdabc455c7900aull, 0x3fcd4db6f8b2514full, 0x3fccf00f8a5e6fccull,
    0x3fcc92cd9971df53ull, 0x3fcc35f0b7d89d47ull, 0x3fcbd9787abe18a1ull, 0x3fcb7d647a8731aaull,
    0x3fcb21b452ccd13aull, 0x3fcac667a2571807ull, 0x3fca6b7e0b19267eull, 0x3fca10f7322d7e3dull,
    0x3fc9b6d2bfd2fe5aull, 0x3fc95d105f6a7c27ull, 0x3fc903afbf74fa69ull, 0x3fc8aab09192815bull,
    0x3fc852128a819a38ull, 0x3fc7f9d5621f7175ull, 0x3fc7a1f8d368a323ull, 0x3fc74a7c9c7ab5a6ull,
    0x3fc6f3607e964716ull, 0x3fc69ca43e21f25cull, 0x3fc64647a2adf19cull, 0x3fc5f04a76f883f9ull,
    0x3fc59aac88f31d6cull, 0x3fc5456da9c86835ull, 0x3fc4f08dade31fc1ull, 0x3fc49c0c6cf5ce2dull,
    0x3fc447e9c20375d5ull, 0x3fc3f4258b6931aeull, 0x3fc3a0bfaae8d7eeull, 0x3fc34db805b4ab88ull,
    0x3fc2fb0e847c2a65ull, 0x3fc2a8c3137a071aull, 0x3fc256d5a2835eb7ull, 0x3fc2054625183c34ull,
    0x3fc1b41492757d42ull, 0x3fc16340e5a82d63ull, 0x3fc112cb1da26eb9ull, 0x3fc0c2b33d5209baull,
    0x3fc072f94bb8bf85ull, 0x3fc0239d54067d2aull, 0x3fbfa93ecb6b222cull, 0x3fbf0bff29520e1cull,
    0x3fbe6f7bf29aa54bull, 0x3fbdd3b56176e88full, 0x3fbd38abb9bd91e5ull, 0x3fbc9e5f493b740aull,
    0x3fbc04d0680b1015ull, 0x3fbb6bff78f2e233ull, 0x3fbad3ece9caf633ull, 0x3fba3c9933ea6286ull,
    0x3fb9a604dc9d5b19ull, 0x3fb9103075a4a0abull, 0x3fb87b1c9dbf2852ull, 0x3fb7e6ca013eefd6ull,
    0x3fb753395aaa1176ull, 0x3fb6c06b73694a4cull, 0x3fb62e6124854d18ull, 0x3fb59d1b577466a4ull,
    0x3fb50c9b06fa2baeull, 0x3fb47ce1401b2213ull, 0x3fb3edef23269a86ull, 0x3fb35fc5e4d93e70ull,
    0x3fb2d266cf9b3111ull, 0x3fb245d344dd0d91ull, 0x3fb1ba0cbe97897dull, 0x3fb12f14d0f2179dull,
    0x3fb0a4ed2c159625ull, 0x3fb01b979e30e497ull, 0x3faf262c2b6c6e35ull, 0x3fae16d547b25181ull,
    0x3fad092efeadf162ull, 0x3fabfd3e0f282a2cull, 0x3faaf30790385f70ull, 0x3fa9ea90f9295563ull,
    0x3fa8e3e02a68b5abull, 0x3fa7defb77af271eull, 0x3fa6dbe9b398d064ull, 0x3fa5dab23cf2add4ull,
    0x3fa4db5d0e11275dull, 0x3fa3ddf2ce98eecbull, 0x3fa2e27ce83df497ull, 0x3fa1e9059f1f6abcull,
    0x3fa0f1982e968011ull, 0x3f9ff881d718a5c4ull, 0x3f9e121adb828c75ull, 0x3f9c301983cd091aull,
    0x3f9a529f4e22ebf8ull, 0x3f9879d1b600c10aull, 0x3f96a5daf40bbf82ull, 0x3f94d6eaf2fbb064ull,
    0x3f930d388dab5e13ull, 0x3f91490334603012ull, 0x3f8f152a4f72dd49ull, 0x3f8ba48d274f8facull,
    0x3f8841040d8da478ull, 0x3f84eb96421acfe0ull, 0x3f81a59229952f92ull, 0x3f7ce160f8ec6837ull,
    0x3f769ea8d90cb85dull, 0x3f708a1f03b0b1fdull, 0x3f655f9f43c1b067ull, 0x3f54a605b6b9f70full,
};

constexpr int kThreads = 256;      // a block of every kernel but the scan
constexpr int kPerThread = 16;     // positions a thread
constexpr int kTile = kThreads * kPerThread;  // ops/normal_draw.py::TILE
constexpr int kScanThreads = 1024;
constexpr unsigned kYield = 0x8000u;
constexpr unsigned kLenMask = 0x7fffu;
constexpr unsigned kMaxLen = 0x7fffu;
constexpr double kR = 3.6541528853610087963519472518;     // ziggurat_nor_r
constexpr double kInvR = 0.27366123732975827203338247596; // ziggurat_nor_inv_r
constexpr double kU53 = 1.0 / 9007199254740992.0;

enum Meta { kLongest = 0, kTotal = 1, kConsumed = 2, kError = 3 };

struct U128 {
  unsigned long long lo, hi;
};

__device__ __forceinline__ U128 mul(U128 a, U128 b) {
  U128 r;
  r.lo = a.lo * b.lo;
  r.hi = __umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo;
  return r;
}

__device__ __forceinline__ U128 add(U128 a, U128 b) {
  U128 r;
  r.lo = a.lo + b.lo;
  r.hi = a.hi + b.hi + (r.lo < a.lo ? 1ull : 0ull);
  return r;
}

__device__ __forceinline__ U128 pcg_mult() {
  U128 m;
  m.lo = 0x4385DF649FCCF645ull;
  m.hi = 0x2360ED051FC65DA4ull;
  return m;
}

// The map of `delta` LCG steps, s -> m * s + p (numpy's pcg_advance_lcg_128).
__device__ void jump(unsigned long long delta, U128 inc, U128& m, U128& p) {
  U128 cur_m = pcg_mult(), cur_p = inc, one;
  one.lo = 1;
  one.hi = 0;
  m = one;
  p.lo = 0;
  p.hi = 0;
  while (delta) {
    if (delta & 1) {
      m = mul(m, cur_m);
      p = add(mul(p, cur_m), cur_p);
    }
    cur_p = mul(add(cur_m, one), cur_p);
    cur_m = mul(cur_m, cur_m);
    delta >>= 1;
  }
}

__device__ __forceinline__ U128 step(U128 s, U128 inc) { return add(mul(s, pcg_mult()), inc); }

// PCG64's XSL-RR output of a state
__device__ __forceinline__ unsigned long long output(U128 s) {
  const unsigned long long x = s.hi ^ s.lo;
  const unsigned rot = (unsigned)(s.hi >> 58);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

__device__ __forceinline__ double uniform(unsigned long long raw) {
  return __dmul_rn(__ull2double_rn(raw >> 11), kU53);
}

__device__ __forceinline__ unsigned attempt_len(const unsigned short* info, int q) {
  return info[q] & kLenMask;
}

// No attempt that starts before chain position c reaches past it.
__device__ __forceinline__ bool clear(const unsigned short* info, int c, int longest) {
  for (int k = 1; k < longest && k <= c; ++k)
    if (attempt_len(info, c - k) > (unsigned)k) return false;
  return true;
}

// Exclusive scan of v over the block; `total` gets the block's sum.
template <int kBlock>
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < kBlock / 32) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  total = warp_sums[kBlock / 32 - 1];
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + inc - v;
}

// Every position's attempt: its value (float, loc + scale * x) and its word
// (length | yield bit); positions at or past `budget` get the word 0.
__global__ void __launch_bounds__(kThreads)
k3_attempts(U128 s0, U128 inc, int budget, double loc, double scale, float* __restrict__ val,
            unsigned short* __restrict__ info, unsigned long long* __restrict__ meta) {
  __shared__ unsigned long long ki[256];
  __shared__ double wi[256];
  ki[threadIdx.x] = kKi[threadIdx.x];
  wi[threadIdx.x] = __longlong_as_double((long long)kWiBits[threadIdx.x]);
  __syncthreads();

  const int first = blockIdx.x * kTile + threadIdx.x;
  U128 m, p, m256, p256;
  jump((unsigned long long)first + 1, inc, m, p);
  U128 s = add(mul(m, s0), p);  // the state whose output is position `first`
  jump(kThreads, inc, m256, p256);
  unsigned longest = 1;
  bool error = false;
  for (int i = 0; i < kPerThread; ++i, s = add(mul(m256, s), p256)) {
    const int pos = first + i * kThreads;
    if (pos >= budget) {
      val[pos] = 0.f;
      info[pos] = 0;
      continue;
    }
    const unsigned long long raw = output(s);
    const int idx = (int)(raw & 0xff);
    const unsigned long long r = raw >> 8;
    const unsigned long long rabs = (r >> 1) & 0x000fffffffffffffull;
    double x = __dmul_rn(__ull2double_rn(rabs), wi[idx]);
    if (r & 1) x = -x;
    unsigned len = 1, yield = kYield;
    if (rabs >= ki[idx]) {
      U128 t = s;
      if (idx == 0) {  // the tail: pairs of outputs until one is taken
        for (;;) {
          t = step(t, inc);
          const double u1 = uniform(output(t));
          t = step(t, inc);
          const double u2 = uniform(output(t));
          len += 2;
          const double xx = __dmul_rn(-kInvR, log1p(-u1));
          const double yy = -log1p(-u2);
          if (__dadd_rn(yy, yy) > __dmul_rn(xx, xx)) {
            x = ((rabs >> 8) & 1) ? -__dadd_rn(kR, xx) : __dadd_rn(kR, xx);
            break;
          }
          if (len + 2 > kMaxLen) {
            error = true;
            yield = 0;
            break;
          }
        }
      } else {  // the wedge: one more output
        t = step(t, inc);
        const double u = uniform(output(t));
        const double f0 = __longlong_as_double((long long)__ldg(&kFiBits[idx - 1]));
        const double f1 = __longlong_as_double((long long)__ldg(&kFiBits[idx]));
        len = 2;
        const double bound = exp(__dmul_rn(__dmul_rn(-0.5, x), x));
        if (!(__dadd_rn(__dmul_rn(__dsub_rn(f0, f1), u), f1) < bound)) yield = 0;
      }
    }
    val[pos] = __double2float_rn(__dadd_rn(loc, __dmul_rn(scale, x)));
    info[pos] = (unsigned short)(len | yield);
    longest = max(longest, len);
  }
  for (int d = 16; d > 0; d >>= 1) longest = max(longest, __shfl_xor_sync(0xffffffffu, longest, d));
  if ((threadIdx.x & 31) == 0) atomicMax(&meta[kLongest], (unsigned long long)longest);
  if (error) meta[kError] = 1;
}

// From each longer attempt that lies on the chain for certain, a walk along
// the chain marking the positions inside its attempts.
__global__ void __launch_bounds__(kThreads)
k3_resolve(const unsigned short* __restrict__ info, unsigned char* __restrict__ skip, int budget,
           const unsigned long long* __restrict__ meta) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= budget || attempt_len(info, p) == 1) return;
  const int longest = (int)meta[kLongest];
  if (!clear(info, p, longest)) return;  // an earlier walk takes it
  int c = p;
  for (;;) {
    const int len = (int)attempt_len(info, c);
    for (int j = 1; j < len && c + j < budget; ++j) skip[c + j] = 1;
    c += len;
    if (c >= budget || clear(info, c, longest)) break;
  }
}

// A thread's 16 consecutive positions: the yield bits of those the chain
// passes through.
__device__ __forceinline__ unsigned chain_yields(const unsigned short* info,
                                                 const unsigned char* skip, int base,
                                                 unsigned short (&word)[kPerThread]) {
  const uint4* w4 = reinterpret_cast<const uint4*>(info + base);
  const uint4 a = w4[0], b = w4[1];
  const uint4 sk = *reinterpret_cast<const uint4*>(skip + base);
  const unsigned wa[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const unsigned sa[4] = {sk.x, sk.y, sk.z, sk.w};
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    word[j] = (unsigned short)(wa[j >> 1] >> (16 * (j & 1)));
    const unsigned skipped = (sa[j >> 2] >> (8 * (j & 3))) & 0xffu;
    if ((word[j] & kYield) && !skipped) bits |= 1u << j;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
k3_count(const unsigned short* __restrict__ info, const unsigned char* __restrict__ skip,
         int* __restrict__ tile_count) {
  unsigned short word[kPerThread];
  const int base = blockIdx.x * kTile + threadIdx.x * kPerThread;
  int total;
  block_exclusive_scan<kThreads>(__popc(chain_yields(info, skip, base, word)), total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
k3_scan(const int* __restrict__ tile_count, int tiles, int* __restrict__ tile_off,
        unsigned long long* __restrict__ meta) {
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(tiles, (int)threadIdx.x * per), hi = min(tiles, lo + per);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += tile_count[t];
  int total;
  int off = block_exclusive_scan<kScanThreads>(sum, total);
  for (int t = lo; t < hi; ++t) {
    tile_off[t] = off;
    off += tile_count[t];
  }
  if (threadIdx.x == 0) meta[kTotal] = (unsigned long long)total;
}

__global__ void __launch_bounds__(kThreads)
k3_write(const unsigned short* __restrict__ info, const unsigned char* __restrict__ skip,
         const float* __restrict__ val, const int* __restrict__ tile_off, long long n,
         float* __restrict__ out, unsigned long long* __restrict__ meta) {
  __shared__ float stage[kTile];
  const long long tile_base = tile_off[blockIdx.x];
  if (tile_base >= n) return;  // the whole block: the first n values lie before this tile
  unsigned short word[kPerThread];
  const int base = blockIdx.x * kTile + threadIdx.x * kPerThread;
  const unsigned bits = chain_yields(info, skip, base, word);
  int total;
  int k = block_exclusive_scan<kThreads>(__popc(bits), total);
  const float4* v4 = reinterpret_cast<const float4*>(val + base);
  float v[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const float4 f = v4[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (!(bits & (1u << j))) continue;
    stage[k] = v[j];
    if (tile_base + k == n - 1)  // the end of the attempt that yields value n - 1
      meta[kConsumed] = (unsigned long long)(base + j) + (word[j] & kLenMask);
    ++k;
  }
  __syncthreads();
  const int limit = (int)min((long long)total, n - tile_base);
  for (int i = threadIdx.x; i < limit; i += kThreads) out[tile_base + i] = stage[i];
}

}  // namespace

// One draw of n values from the stream after state s (128 bits, lo and hi)
// with increment inc, counted against `budget` positions. Scratch, each
// over tiles * 4096 positions (tiles = ceil(budget / 4096)): val float,
// info 16-bit, skip bytes; tile_count and tile_off int [tiles]; meta 4
// 64-bit words (longest attempt, values the budget yields, outputs
// consumed, error). Launches on `stream`, does not synchronise, and returns
// the first launch error (0 on success).
extern "C" int normal_draw(unsigned long long s_lo, unsigned long long s_hi,
                           unsigned long long inc_lo, unsigned long long inc_hi, long long n,
                           int budget, double loc, double scale, float* out, float* val,
                           unsigned short* info, unsigned char* skip, int* tile_count,
                           int* tile_off, unsigned long long* meta, cudaStream_t stream) {
  const int tiles = (budget + kTile - 1) / kTile;
  U128 s0, inc;
  s0.lo = s_lo;
  s0.hi = s_hi;
  inc.lo = inc_lo;
  inc.hi = inc_hi;
  cudaError_t err = cudaMemsetAsync(skip, 0, (size_t)tiles * kTile, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(meta, 0, 4 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  k3_attempts<<<tiles, kThreads, 0, stream>>>(s0, inc, budget, loc, scale, val, info, meta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3_resolve<<<(budget + kThreads - 1) / kThreads, kThreads, 0, stream>>>(info, skip, budget, meta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3_count<<<tiles, kThreads, 0, stream>>>(info, skip, tile_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3_scan<<<1, kScanThreads, 0, stream>>>(tile_count, tiles, tile_off, meta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3_write<<<tiles, kThreads, 0, stream>>>(info, skip, val, tile_off, n, out, meta);
  return (int)cudaGetLastError();
}
